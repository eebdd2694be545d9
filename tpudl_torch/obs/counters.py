"""Process-wide counters / gauges / histograms with snapshot export.

A copy of tpudl.obs.counters (stdlib-only, so the port keeps its own
instead of importing the JAX package). The numeric complement of
tpudl_torch.obs.spans: spans say WHEN time went
somewhere, counters say HOW MUCH of something accumulated (bytes
ingested, checkpoint saves, worker retries) and histograms hold the
per-step latency distributions (step_time, data_wait, compile_time,
checkpoint_time) the report quotes p50/p95/p99 from.

Stdlib-only and thread-safe like the span recorder. One module-level
default registry; ``registry().snapshot()`` produces a plain-dict
summary that rides the span JSONL stream as a ``{"kind": "counters"}``
record (``SpanRecorder.counters``), so one file carries both."""

from __future__ import annotations

import math
import threading

from tpudl_torch.analysis.registry import env_int
from typing import Dict, List, Optional

#: Default rolling-window size for Histogram (see TPUDL_OBS_HIST_WINDOW).
DEFAULT_HIST_WINDOW = 65_536


class Counter:
    """Monotonically increasing count (events, bytes, retries)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc is monotonic, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar (current lr, queue depth, loss)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


def percentile(sorted_values: List[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default) on an already
    SORTED list — stdlib-only so the obs layer carries no numpy
    dependency."""
    if not sorted_values:
        return math.nan
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = (len(sorted_values) - 1) * q
    lo = int(math.floor(pos))
    hi = int(math.ceil(pos))
    if lo == hi:
        return sorted_values[lo]
    frac = pos - lo
    return sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac


class Histogram:
    """Latency/size distribution over a bounded rolling window.

    Up to ``window`` raw observations are kept (default 65,536,
    overridable via ``TPUDL_OBS_HIST_WINDOW``), so snapshots report
    EXACT percentiles — of the most recent window — rather than bucket
    estimates. Past the window the oldest observation is ring-evicted:
    a long-lived serving process holds a fixed ~512 KB of floats per
    histogram instead of growing without bound (and each ``snapshot()``
    sorts a bounded list instead of the full run history). ``count``
    and ``sum`` stay CUMULATIVE over every observation ever made — the
    monotone pair Prometheus rate() math needs — while min/max/mean of
    the *windowed* values describe recent behavior."""

    __slots__ = ("_lock", "_values", "_window", "_count", "_sum")

    def __init__(self, window: Optional[int] = None):
        if window is None:
            window = env_int("TPUDL_OBS_HIST_WINDOW", DEFAULT_HIST_WINDOW)
        if window < 1:
            raise ValueError(f"histogram window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self._values: List[float] = []
        self._window = window
        self._count = 0
        self._sum = 0.0

    @property
    def window(self) -> int:
        return self._window

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            if len(self._values) < self._window:
                self._values.append(v)
            else:
                # Ring-evict the oldest: slot i of the full buffer holds
                # observation (count - window + i), so the write cursor
                # is simply count modulo window.
                self._values[self._count % self._window] = v
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        """Cumulative observation count (not capped by the window)."""
        return self._count

    @property
    def values(self) -> List[float]:
        """The windowed observations, oldest first."""
        with self._lock:
            if self._count <= self._window:
                return list(self._values)
            cursor = self._count % self._window
            return self._values[cursor:] + self._values[:cursor]

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._values)
            count, total = self._count, self._sum
        if not vals:
            return {"count": 0}
        return {
            "count": count,
            "sum": total,
            "min": vals[0],
            "max": vals[-1],
            # Windowed like min/max/percentiles (self-consistent recent
            # view); count/sum above stay cumulative for rate() math.
            # Identical to sum/count until the window first wraps.
            "mean": sum(vals) / len(vals),
            "p50": percentile(vals, 0.50),
            "p95": percentile(vals, 0.95),
            "p99": percentile(vals, 0.99),
        }


class Registry:
    """Name -> instrument map with get-or-create accessors. A name is
    bound to ONE kind; re-requesting it as another kind raises (two
    subsystems silently sharing "step_time" as counter and histogram
    would corrupt both)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls()
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"instrument {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """Plain-dict summary of every instrument, JSON-ready."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.snapshot()
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def registry() -> Registry:
    """The process-wide default registry (created on first use)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = Registry()
    return _default
