"""Host-side span/event recorder: the wall-clock half of observability.

A copy of tpudl.obs.spans (stdlib-only, so the port keeps its own
instead of importing the JAX package). It answers "where does the RUN
go" by recording host-side spans around the runtime's blocking calls.
Records are plain dicts with a monotonic timestamp, duration, category,
and host/process tags, streamed as JSONL in the same schema as the JAX
package's, so ``python -m tpudl.obs.report`` reads either package's
files. The instrumented layers: the train loop (tpudl_torch.train.fit
and evaluate: data waits, compile, steps, eval), the serving path, the
fault-tolerance layer (tpudl_torch.ft: checkpoint saves, background
writes, recovery) and the data layer's ingest (tpudl_torch.data.ingest).
tpudl_torch.obs.goodput classifies the records.

Design constraints, all load-bearing:

- **zero hard dependencies** — stdlib only, importable everywhere;
- **thread-safe** — background threads record concurrently with the
  serving loop;
- **injectable clock** — tests pass a fake monotonic clock and get
  byte-deterministic exports;
- **disabled is free** — ``active_recorder()`` returns None unless
  ``enable()`` was called or TPUDL_OBS_DIR is set; instrumentation
  sites guard on that None.

Activation: set ``TPUDL_OBS_DIR=/path`` (or call ``enable(path)``) and
every instrumented layer streams into
``spans-<host>-p<process>-<pid>.jsonl`` under it.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import threading
import time
from typing import Callable, Optional

from tpudl_torch.analysis.registry import env_int, env_str

#: Span categories the goodput classifier understands
#: (tpudl_torch.obs.goodput), with tpudl.obs.spans's names.
#: Instrumentation may invent others; they land in the "other" bucket.
CAT_STEP = "step"
CAT_EVAL = "eval"
#: A compiled step's first calls: on the card its eager warm-up and its
#: CUDA-graph capture (tpudl's XLA compile).
CAT_COMPILE = "compile"
CAT_DATA_WAIT = "data_wait"
#: Time the train loop blocked on metric readback — separate from
#: data_wait so a report distinguishes "starved for batches" from
#: "throttled by telemetry".
CAT_METRIC_WAIT = "metric_wait"
#: The step path's checkpoint stall: the host snapshot and the
#: back-pressure of a save, and restores.
CAT_CHECKPOINT = "checkpoint"
#: Time lost to failure recovery (the supervisor's backoff between a
#: failed attempt and its relaunch).
CAT_RECOVERY = "recovery"
#: Background checkpoint writes (tpudl_torch.ft.writer): they overlap
#: train steps, so they are reported and never charged to the run.
CAT_CKPT_BG = "ckpt_bg"
#: Enclosing lifetime spans (a worker's whole run): they overlap the
#: categorized spans inside them, so the goodput classifier uses them
#: only to extend the run window, never as accounted time.
CAT_ENCLOSING = "worker"


class _Span:
    """Context manager recording one span on exit (``SpanRecorder.span``;
    the module-level ``span()`` returns a shared no-op when recording is
    off)."""

    __slots__ = ("_rec", "_name", "_cat", "_attrs", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str, cat: str,
                 attrs: dict):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._attrs = attrs

    def __enter__(self) -> "_Span":
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.record(self._name, self._cat, self._t0,
                         self._rec.clock() - self._t0, self._attrs)


class _NullSpan:
    """Shared no-op context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class SpanRecorder:
    """Thread-safe span/event sink with streaming JSONL and in-memory
    record lists.

    Every record is a flat dict:

    - spans:    ``{"kind": "span", "name", "cat", "ts", "dur", "host",
      "process", "pid", "tid", ...attrs}``
    - events:   ``{"kind": "event", "name", "cat", "ts", ...tags}``
    - counters: ``{"kind": "counters", "ts", "data": {...}}`` (a
      tpudl_torch.obs.counters snapshot riding the same stream)

    ``ts``/``dur`` are seconds on the injected monotonic ``clock``
    (default ``time.monotonic`` — comparable within one process, not
    across hosts; the report aggregates durations, never cross-host
    timestamps).
    """

    def __init__(
        self,
        path: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
        host: Optional[str] = None,
        process: Optional[int] = None,
    ):
        self.clock = clock
        self.path = path
        self.host = host if host is not None else socket.gethostname()
        self.process = (
            process
            if process is not None
            else env_int("TPUDL_PROCESS_ID", 0)
        )
        self._lock = threading.Lock()
        self._records: list = []
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a")

    # -- recording -----------------------------------------------------

    def span(self, name: str, cat: str = CAT_STEP, **attrs) -> _Span:
        """Context manager: ``with rec.span("save", "checkpoint"): ...``"""
        return _Span(self, name, cat, attrs)

    def record(
        self, name: str, cat: str, ts: float, dur: float,
        attrs: Optional[dict] = None,
    ) -> dict:
        """Append one completed span (the explicit form the hot loops use
        so the disabled branch stays allocation-free)."""
        rec = {
            "kind": "span", "name": name, "cat": cat,
            "ts": ts, "dur": dur,
            "host": self.host, "process": self.process,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if attrs:
            rec.update(attrs)
        self._emit(rec)
        return rec

    def event(self, name: str, cat: str = "event", **tags) -> dict:
        """Instant (zero-duration) event — e.g. a per-step metrics blob.
        ``tags`` must not use the reserved record keys (kind/name/cat/
        ts/host/process/pid); nest free-form payloads under one tag."""
        rec = {
            "kind": "event", "name": name, "cat": cat, "ts": self.clock(),
            "host": self.host, "process": self.process, "pid": os.getpid(),
        }
        reserved = set(rec) & set(tags)
        if reserved:
            raise ValueError(
                f"event tags collide with reserved record keys: "
                f"{sorted(reserved)} — nest them under one tag instead"
            )
        rec.update(tags)
        self._emit(rec)
        return rec

    def counters(self, snapshot: dict) -> dict:
        """Attach a tpudl_torch.obs.counters snapshot to the stream."""
        rec = {
            "kind": "counters", "ts": self.clock(),
            "host": self.host, "process": self.process, "pid": os.getpid(),
            "data": snapshot,
        }
        self._emit(rec)
        return rec

    def _emit(self, rec: dict) -> None:
        # Streamed OR buffered, never both: a file-backed recorder keeps
        # nothing in memory (a million-step run must not grow the host
        # RSS by its own telemetry); `records` re-reads the file.
        with self._lock:
            if self._file is not None:
                self._file.write(json.dumps(rec) + "\n")
                self._file.flush()
            else:
                self._records.append(rec)

    # -- export --------------------------------------------------------

    @property
    def records(self) -> list:
        with self._lock:
            if self.path is not None:
                if not os.path.exists(self.path):
                    return []
                return read_jsonl(self.path)
            return list(self._records)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "SpanRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> list:
    """Load one span JSONL file back into record dicts.

    A TORN FINAL LINE is skipped, not raised: span files are written
    append-only by live processes, so a worker SIGKILLed mid-flush
    legitimately leaves a partial last record — and the distributor's
    merge runs exactly when workers died, where a JSONDecodeError would
    mask the real failure. Corruption anywhere else still raises."""
    records = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln]
    for idx, line in enumerate(lines):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if idx == len(lines) - 1:
                break  # torn tail of a killed writer
            raise
    return records


# ---------------------------------------------------------------------------
# Module-level active recorder (the switch every instrumentation site
# consults).
# ---------------------------------------------------------------------------

_active: Optional[SpanRecorder] = None
_atexit_registered = False


def default_span_path(directory: str) -> str:
    """Per-(host, process-index, os-pid) span file under ``directory`` —
    collision-free when a distributor parent and its rank-0 worker share
    the directory."""
    host = socket.gethostname()
    proc = env_int("TPUDL_PROCESS_ID", 0)
    return os.path.join(
        directory, f"spans-{host}-p{proc}-{os.getpid()}.jsonl"
    )


def enable(
    path: str,
    clock: Callable[[], float] = time.monotonic,
    process: Optional[int] = None,
) -> SpanRecorder:
    """Activate recording. ``path`` is a directory (a per-process
    ``spans-*.jsonl`` is created inside) or an explicit ``*.jsonl``
    file. Idempotent per path; re-enabling replaces the active
    recorder."""
    global _active, _atexit_registered
    if _active is not None:
        _active.close()
    file_path = (
        path if path.endswith(".jsonl") else default_span_path(path)
    )
    _active = SpanRecorder(file_path, clock=clock, process=process)
    if not _atexit_registered:
        atexit.register(disable)
        _atexit_registered = True
    return _active


def disable() -> None:
    """Deactivate and flush the active recorder (no-op when inactive)."""
    global _active
    if _active is not None:
        _active.close()
        _active = None


def active_recorder() -> Optional[SpanRecorder]:
    """The active recorder, auto-enabling from TPUDL_OBS_DIR on first
    call (mirrors fit()'s TPUDL_PROFILE_DIR idiom) — None when disabled,
    which is the branch every hot path takes for free."""
    if _active is not None:
        return _active
    obs_dir = env_str("TPUDL_OBS_DIR")
    if obs_dir:
        return enable(obs_dir)
    return None


def span(name: str, cat: str = CAT_STEP, **attrs):
    """A recording context manager when observability is on, a shared
    no-op otherwise. Cold paths use this (checkpoint restores); per-step
    loops use the explicit ``active_recorder()``/``record()`` form."""
    rec = active_recorder()
    if rec is None:
        return _NULL_SPAN
    return rec.span(name, cat, **attrs)
