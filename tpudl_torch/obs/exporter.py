"""Live telemetry plane: background HTTP exporter + health sources.

A copy of tpudl.obs.exporter (stdlib only; the port keeps its own),
without tpudl's per-tenant metering series on ``/metrics`` (the
metering plane is ROADMAP queue A item 16(b)). Spans land in JSONL and
are read after the process exits; this module is the LIVE half — a stdlib-only background HTTP
server any operator (or the serve router) can query while the process
runs:

- ``GET /metrics``  — Prometheus text exposition rendered from
  ``Registry.snapshot()``: counters and gauges verbatim, histograms as
  ``_count``/``_sum`` plus exact-quantile gauges (``quantile`` label),
  and one ``*_heartbeat_age_s`` gauge per registered heartbeat.
- ``GET /healthz``  — liveness + readiness JSON: every registered
  health source (serve engine slots/queue, checkpoint writer sticky
  errors, SLO monitor burn state) plus heartbeat ages (train-loop last
  step). tpudl's MetricFetcher source is ROADMAP queue A item 10, its
  distributor's per-rank heartbeats item 7. HTTP 200 when every
  source is healthy and no running heartbeat is stale, 503 otherwise —
  a k8s/probe-compatible contract.
- ``GET /snapshot`` — the full JSON registry snapshot, the health
  report, and the live goodput classification of the active span
  stream (what ``report.py`` would print, computed in-process).

Activation mirrors the span recorder's: set ``TPUDL_OBS_PORT``
(``fit()`` and ``ServeSession`` call ``maybe_start_from_env()``), or
construct/start an ``ObsExporter`` directly — port 0 binds an
ephemeral port (``.port`` reports the real one), which is how tests
inject it. Stdlib-only and thread-safe like the rest of tpudl_torch.obs:
scrapes run concurrently with observation on the instrument locks.

Health sources are process-global so instrumented subsystems need no
handle on the exporter: ``register_health_source(name, fn)`` with
``fn() -> dict`` (a ``"healthy": bool`` key; absent means healthy, a
raising source reports unhealthy with the error). ``Heartbeat`` is the
liveness flavor: a component beats it each unit of progress and the
exporter reports the age, flagging a RUNNING heartbeat that has gone
stale — how a hung train loop or rank becomes visible within seconds
instead of at post-mortem.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from tpudl_torch.analysis.registry import env_float, env_int, env_str
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import spans as obs_spans

#: A running heartbeat older than this is stale (seconds); override
#: per-heartbeat or via TPUDL_OBS_HEARTBEAT_STALE_S.
DEFAULT_HEARTBEAT_STALE_S = 60.0

_state_lock = threading.Lock()
_health_sources: Dict[str, Callable[[], dict]] = {}
_heartbeats: Dict[str, "Heartbeat"] = {}


# ---------------------------------------------------------------------------
# Health sources + heartbeats
# ---------------------------------------------------------------------------


def register_health_source(name: str, fn: Callable[[], dict]) -> None:
    """Register (or replace) a named health callable. ``fn`` returns a
    JSON-ready dict; a ``"healthy": False`` key marks the component
    unhealthy (absent counts as healthy); a raising ``fn`` reports
    unhealthy with the exception text instead of breaking the probe."""
    with _state_lock:
        _health_sources[name] = fn


def unregister_health_source(name: str) -> None:
    with _state_lock:
        _health_sources.pop(name, None)


class Heartbeat:
    """Progress liveness signal: ``beat()`` each unit of work; the
    exporter reports the age and flags a running-but-stale heartbeat as
    unhealthy. ``stop()`` marks orderly completion (a stopped heartbeat
    is never stale — "finished" is healthy, "hung" is not).

    Staleness is ADAPTIVE to the beat cadence: the threshold is
    ``max(stale_after, adaptive_factor x the last beat interval)``, so
    a train loop whose fused dispatch windows legitimately take minutes
    is not flagged hung between beats — only a beat gap far outside
    its own established rhythm is."""

    def __init__(
        self,
        name: str,
        stale_after: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        register: bool = True,
        adaptive_factor: float = 5.0,
    ):
        if stale_after is None:
            stale_after = env_float(
                "TPUDL_OBS_HEARTBEAT_STALE_S", DEFAULT_HEARTBEAT_STALE_S
            )
        self.name = name
        self.stale_after = stale_after
        self.adaptive_factor = adaptive_factor
        self.clock = clock
        self._lock = threading.Lock()
        self._last: Optional[float] = None
        self._interval: Optional[float] = None
        self._step: Optional[int] = None
        self._running = True
        if register:
            with _state_lock:
                _heartbeats[name] = self

    def beat(self, step: Optional[int] = None) -> None:
        self.beat_at(self.clock(), step=step)

    def beat_at(self, t: float, step: Optional[int] = None) -> None:
        """Record a beat observed to have happened at clock time ``t``
        (the distributor's span-file-mtime path, where the parent infers
        a rank's progress time rather than witnessing it)."""
        with self._lock:
            if self._last is not None and t > self._last:
                self._interval = t - self._last
            self._last = t
            if step is not None:
                self._step = int(step)
            self._running = True

    def stop(self) -> None:
        with self._lock:
            self._running = False

    def unregister(self) -> None:
        with _state_lock:
            if _heartbeats.get(self.name) is self:
                del _heartbeats[self.name]

    def age_s(self) -> Optional[float]:
        with self._lock:
            if self._last is None:
                return None
            return max(0.0, self.clock() - self._last)

    def stale_threshold_s(self) -> float:
        with self._lock:
            interval = self._interval
        if interval is None:
            return self.stale_after
        return max(self.stale_after, self.adaptive_factor * interval)

    def health(self) -> dict:
        age = self.age_s()
        threshold = self.stale_threshold_s()
        with self._lock:
            running, step = self._running, self._step
        stale = bool(running and age is not None and age > threshold)
        out = {
            "running": running,
            "age_s": age,
            "stale_threshold_s": threshold,
            "stale": stale,
            "healthy": not stale,
        }
        if step is not None:
            out["step"] = step
        return out


def heartbeat_ages() -> Dict[str, float]:
    """Current age per registered heartbeat (beaten ones only) —
    the cheap read /metrics needs, WITHOUT evaluating health sources
    (a source like SloMonitor.health has transition side effects; a
    scrape endpoint must not drive them)."""
    with _state_lock:
        hearts = dict(_heartbeats)
    out: Dict[str, float] = {}
    for name, hb in hearts.items():
        age = hb.age_s()
        if age is not None:
            out[name] = age
    return out


def health_snapshot() -> dict:
    """Evaluate every health source and heartbeat into one JSON-ready
    report with an overall ``healthy`` verdict."""
    with _state_lock:
        sources = dict(_health_sources)
        hearts = dict(_heartbeats)
    report: dict = {"sources": {}, "heartbeats": {}}
    healthy = True
    for name, fn in sorted(sources.items()):
        try:
            s = dict(fn())
        except Exception as e:  # a broken source IS an unhealthy source
            s = {"healthy": False, "error": f"{type(e).__name__}: {e}"}
        s.setdefault("healthy", True)
        healthy = healthy and bool(s["healthy"])
        report["sources"][name] = s
    for name, hb in sorted(hearts.items()):
        h = hb.health()
        healthy = healthy and h["healthy"]
        report["heartbeats"][name] = h
    report["healthy"] = healthy
    return report


def _reset_health_for_tests() -> None:
    """Drop every registered source/heartbeat (process-global state —
    the test-isolation analog of Registry.reset)."""
    with _state_lock:
        _health_sources.clear()
        _heartbeats.clear()


# ---------------------------------------------------------------------------
# Prometheus text rendering
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_NAME_OK = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

#: Exact-percentile quantiles rendered per histogram (the keys
#: Registry.snapshot already computes).
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _metric_name(name: str) -> str:
    name = _NAME_FIX.sub("_", name)
    if not _NAME_OK.match(name):
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _label_value(v) -> str:
    """Escape one label value per the exposition format (backslash,
    quote, newline)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def format_labels(labels: Optional[Dict[str, str]]) -> str:
    """``{"source": "replica1"}`` -> ``{source="replica1"}`` (empty
    string for no labels). Label NAMES must already be exposition-legal
    — they come from code, not data, so a bad one is a caller bug and
    raises rather than being silently mangled into the metric name."""
    if not labels:
        return ""
    for k in labels:
        if not _LABEL_NAME_OK.match(k):
            raise ValueError(f"illegal Prometheus label name {k!r}")
    inner = ",".join(
        f'{k}="{_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(
    snapshot: dict,
    heartbeats: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
) -> str:
    """A ``Registry.snapshot()`` dict -> Prometheus text exposition
    (version 0.0.4). Counters and gauges render verbatim; histograms as
    summaries: cumulative ``_count``/``_sum`` plus exact-quantile rows
    over the bounded window. ``heartbeats`` (name -> age seconds, see
    ``heartbeat_ages``) ride along as gauges.

    ``labels`` attaches the same label set to every series (the fleet
    view's ``{source="replica1"}``) instead of mangling provenance into
    metric names; histogram quantile rows merge it with their
    ``quantile`` label. ``labels=None`` output is byte-identical to the
    pre-label renderer (regression-tested)."""
    suffix = format_labels(labels)
    lines = []
    for name, value in sorted(snapshot.get("counters", {}).items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{suffix} {_fmt(value)}")
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{suffix} {_fmt(value)}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} summary")
        if h.get("count"):
            for q, key in _QUANTILES:
                qsuffix = format_labels(
                    {**(labels or {}), "quantile": q}
                )
                lines.append(f"{m}{qsuffix} {_fmt(h[key])}")
        lines.append(f"{m}_sum{suffix} {_fmt(h.get('sum', 0.0))}")
        lines.append(f"{m}_count{suffix} {int(h.get('count', 0))}")
    for name, age in sorted((heartbeats or {}).items()):
        m = _metric_name(f"{name}_heartbeat_age_s")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{suffix} {_fmt(age)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The HTTP server
# ---------------------------------------------------------------------------


class ObsExporter:
    """Background HTTP server over the obs registry + health state.

    ``port=0`` binds an ephemeral port; ``.port`` reports the bound
    one. ``registry`` defaults to the process-wide default at serve
    time (not bound at construction, so a test-reset registry is picked
    up). One OS thread per in-flight request (ThreadingHTTPServer), so
    a slow scrape never blocks the health probe.

    The default bind is LOOPBACK: the endpoints are unauthenticated,
    so exposing them beyond the host is an explicit choice —
    ``host="0.0.0.0"`` (or ``TPUDL_OBS_HOST`` for the env-activated
    exporter) for a containerized scraper."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[obs_counters.Registry] = None,
    ):
        self._registry = registry
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._host = host
        self._requested_port = int(port)

    # -- payload assembly (also the testable seam) ---------------------

    def _reg(self) -> obs_counters.Registry:
        return (
            self._registry
            if self._registry is not None
            else obs_counters.registry()
        )

    def metrics_text(self) -> str:
        # tpudl appends the per-tenant metering series here (ROADMAP
        # queue A item 16(b)).
        return render_prometheus(self._reg().snapshot(), heartbeat_ages())

    def health(self) -> dict:
        return health_snapshot()

    def snapshot(self) -> dict:
        out = {
            "time": time.time(),
            "registry": self._reg().snapshot(),
            "health": health_snapshot(),
            "goodput": None,
            # Span-stream discovery: when TPUDL_OBS_DIR is active this
            # names the file the process is streaming spans into (what
            # tpudl's fleet trace stitcher reads).
            "span_path": None,
        }
        rec = obs_spans.active_recorder()
        if rec is not None:
            out["span_path"] = (
                os.path.abspath(rec.path) if rec.path else None
            )
            try:
                from tpudl_torch.obs import goodput as goodput_mod

                cls = goodput_mod.classify_by_process(rec.records)
                out["goodput"] = cls["overall"]
                out["goodput_per_process"] = cls["per_process"]
            except Exception as e:
                out["goodput_error"] = f"{type(e).__name__}: {e}"
        return out

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "ObsExporter":
        if self._server is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            exporter.metrics_text().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        h = exporter.health()
                        self._send(
                            200 if h["healthy"] else 503,
                            json.dumps(h).encode(),
                            "application/json",
                        )
                    elif path == "/snapshot":
                        self._send(
                            200,
                            json.dumps(exporter.snapshot()).encode(),
                            "application/json",
                        )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # never kill the server thread
                    try:
                        self._send(
                            500,
                            f"{type(e).__name__}: {e}\n".encode(),
                            "text/plain",
                        )
                    except OSError:
                        pass  # client hung up mid-reply

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tpudl-obs-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        if self._server is None:
            return None
        return self._server.server_address[1]

    @property
    def running(self) -> bool:
        return self._server is not None

    def close(self) -> None:
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ObsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Module-level active exporter (the TPUDL_OBS_PORT switch)
# ---------------------------------------------------------------------------

_active: Optional[ObsExporter] = None
_atexit_registered = False


def start_exporter(
    port: int = 0, host: Optional[str] = None
) -> ObsExporter:
    """Start (or return) the process-wide exporter. Re-calling with the
    exporter already running returns it unchanged — fit() and serving
    may both call this. ``host`` defaults to ``TPUDL_OBS_HOST`` or
    loopback (see ObsExporter)."""
    global _active, _atexit_registered
    if _active is not None and _active.running:
        return _active
    if host is None:
        host = env_str("TPUDL_OBS_HOST", "127.0.0.1")
    _active = ObsExporter(port=port, host=host).start()
    if not _atexit_registered:
        atexit.register(stop_exporter)
        _atexit_registered = True
    return _active


def stop_exporter() -> None:
    global _active
    if _active is not None:
        _active.close()
        _active = None


def active_exporter() -> Optional[ObsExporter]:
    return _active


def maybe_start_from_env() -> Optional[ObsExporter]:
    """Start the process-wide exporter iff ``TPUDL_OBS_PORT`` is set
    (the instrumented-layer hook — one env lookup when disabled). Port
    0 is honored: it binds an ephemeral port, the test idiom.

    A failed BIND on this path warns and returns None instead of
    raising: distributor workers inherit the env (every rank would
    race for one port), and a supervised restart can overlap its
    predecessor's grace window — telemetry is best-effort, it must
    never turn a port conflict into a dead training run. An explicit
    ``start_exporter()``/``ObsExporter.start()`` still raises."""
    if _active is not None and _active.running:
        return _active
    port = env_int("TPUDL_OBS_PORT")
    if port is None:
        return None
    try:
        return start_exporter(port=port)
    except OSError as e:
        import warnings

        warnings.warn(
            f"tpudl_torch.obs: could not bind the telemetry exporter on port "
            f"{port} ({e}); continuing without live telemetry",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
