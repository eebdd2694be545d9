"""Declarative SLOs with multi-window burn-rate alerting.

An ``Objective`` states a latency target the way an operator would:
"p99 of ``serve_ttft_ms`` stays <= 250 ms over a rolling 5 minutes".
The ``SloMonitor`` evaluates a set of objectives from bounded
time-windowed observation streams and reports *burn rate* — how fast
the objective's error budget is being consumed — over a fast and a
slow window (the Google-SRE multiwindow/multi-burn-rate shape):

- the **error budget** of a p-quantile objective is ``1 - quantile``
  (p99 tolerates 1% of observations over threshold);
- a window's **burn rate** is its violating fraction divided by that
  budget (burn 1.0 = consuming budget exactly as fast as allowed;
  burn 20 = twenty times too fast);
- an objective is **burning** when BOTH windows exceed their burn
  thresholds: the slow window proves the breach is sustained (a single
  slow request cannot page), the fast window proves it is *still
  happening* — which is also what makes recovery fast: once the
  overload stops, the fast window drains and the alert clears without
  waiting out the slow window.

Subscribers (``subscribe(cb)``) get a callback on every transition
into or out of burning — the shed/autoscale hook the serve Engine's
admission path attaches to (``Engine.attach_slo``), and the monitor
registers as a ``/healthz`` source (``register_as_health_source``) so
a burning objective flips the probe to 503 with the burn arithmetic in
the body. The clock is injectable; window math is exact and testable
without sleeping. Stdlib-only, thread-safe, bounded memory (each
window is a deque capped in both time and element count).

A copy of tpudl.obs.slo (stdlib only; the port keeps its own).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

#: Cap on buffered observations per window — bounds memory when the
#: observation rate is extreme relative to the window length.
MAX_WINDOW_OBS = 65_536


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective: ``quantile`` of ``metric`` must stay
    <= ``threshold`` over a rolling ``window_s``. ``fast_window_s`` is
    the confirmation window; ``slow_burn``/``fast_burn`` are the burn
    rates each must exceed for the objective to be burning. Windows
    with fewer than ``min_count`` observations report burn 0 — no
    alarm on no data."""

    name: str
    metric: str
    threshold: float
    quantile: float = 0.99
    window_s: float = 300.0
    fast_window_s: float = 30.0
    slow_burn: float = 1.0
    fast_burn: float = 1.0
    min_count: int = 5

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(
                f"quantile must be in (0, 1), got {self.quantile}"
            )
        if self.fast_window_s > self.window_s:
            raise ValueError(
                f"fast_window_s ({self.fast_window_s}) must not exceed "
                f"window_s ({self.window_s})"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.quantile


class _Window:
    """Time+count-bounded (timestamp, violated) buffer with a running
    violation count — O(evictions) trim, O(1) burn-rate readout."""

    __slots__ = ("span_s", "obs", "violations")

    def __init__(self, span_s: float):
        self.span_s = span_s
        self.obs: deque = deque(maxlen=MAX_WINDOW_OBS)
        self.violations = 0

    def add(self, t: float, violated: bool) -> None:
        if len(self.obs) == self.obs.maxlen and self.obs[0][1]:
            self.violations -= 1  # count-cap eviction of a violation
        self.obs.append((t, violated))
        if violated:
            self.violations += 1

    def trim(self, now: float) -> None:
        cutoff = now - self.span_s
        while self.obs and self.obs[0][0] < cutoff:
            if self.obs.popleft()[1]:
                self.violations -= 1

    def stats(self, budget: float, min_count: int) -> dict:
        n = len(self.obs)
        frac = self.violations / n if n else 0.0
        burn = (
            frac / max(budget, 1e-9) if n >= min_count else 0.0
        )
        return {
            "count": n,
            "violations": self.violations,
            "violation_fraction": frac,
            "burn_rate": burn,
        }


class SloMonitor:
    """Evaluate objectives from observation streams; fire subscriber
    callbacks on burning-state transitions.

    Feed it with ``observe(metric, value)`` (the serve engine routes
    its TTFT/TPOT/queue-wait observations here when attached);
    ``evaluate()`` trims windows against the injected clock, recomputes
    burn state, and fires transition callbacks — called from
    ``observe``, from the engine's admission path, and from
    ``/healthz`` probes, so recovery clears by time passing even with
    no new traffic."""

    def __init__(
        self,
        objectives: Sequence[Objective],
        clock: Callable[[], float] = time.monotonic,
    ):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.objectives: List[Objective] = list(objectives)
        self.clock = clock
        self._lock = threading.Lock()
        # Serializes whole evaluations (state transition + callback
        # dispatch): without it, two threads (engine + /healthz probe)
        # could each capture one edge of a burn/clear pair and fire
        # the callbacks in the wrong order, latching a subscriber into
        # the stale state forever. Reentrant so a callback may call
        # observe()/evaluate() itself.
        self._eval_lock = threading.RLock()
        self._by_metric: Dict[str, List[Objective]] = {}
        for o in self.objectives:
            self._by_metric.setdefault(o.metric, []).append(o)
        self._fast: Dict[str, _Window] = {
            o.name: _Window(o.fast_window_s) for o in self.objectives
        }
        self._slow: Dict[str, _Window] = {
            o.name: _Window(o.window_s) for o in self.objectives
        }
        self._burning: Dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self._callbacks: List[Callable[[Objective, dict], None]] = []

    # -- feeding -------------------------------------------------------

    def observe(self, metric: str, value: float) -> None:
        """Record one observation of ``metric`` (same unit as the
        objective threshold) and re-evaluate the objectives watching
        it."""
        targets = self._by_metric.get(metric)
        if not targets:
            return
        now = self.clock()
        with self._lock:
            for o in targets:
                violated = float(value) > o.threshold
                self._fast[o.name].add(now, violated)
                self._slow[o.name].add(now, violated)
        self.evaluate()

    def watched_metrics(self) -> List[str]:
        return list(self._by_metric)

    # -- evaluation ----------------------------------------------------

    def subscribe(self, cb: Callable[[Objective, dict], None]) -> None:
        """``cb(objective, state)`` fires on every transition into or
        out of burning; ``state["burning"]`` is the new state. Fired
        synchronously from whichever thread drove the evaluation."""
        self._callbacks.append(cb)

    def evaluate(self) -> dict:
        """Trim windows to the clock, recompute per-objective burn
        state, fire transition callbacks, and return the full report."""
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> dict:
        now = self.clock()
        report: dict = {}
        transitions: List[tuple] = []
        with self._lock:
            for o in self.objectives:
                fast, slow = self._fast[o.name], self._slow[o.name]
                fast.trim(now)
                slow.trim(now)
                fs = fast.stats(o.budget, o.min_count)
                ss = slow.stats(o.budget, o.min_count)
                burning = (
                    fs["burn_rate"] >= o.fast_burn
                    and ss["burn_rate"] >= o.slow_burn
                )
                state = {
                    "objective": o.name,
                    "metric": o.metric,
                    "threshold": o.threshold,
                    "quantile": o.quantile,
                    "budget": o.budget,
                    "burning": burning,
                    "fast": fs,
                    "slow": ss,
                }
                if burning != self._burning[o.name]:
                    self._burning[o.name] = burning
                    transitions.append((o, state))
                report[o.name] = state
        # Callbacks outside the STATE lock (a subscriber may call
        # observe()/evaluate() reentrantly) but inside the EVAL lock,
        # so cross-thread transition order matches callback order.
        for o, state in transitions:
            for cb in self._callbacks:
                cb(o, state)
        return report

    def burning_names(self) -> List[str]:
        self.evaluate()
        with self._lock:
            return [n for n, b in self._burning.items() if b]

    # -- surfacing -----------------------------------------------------

    def health(self) -> dict:
        """Health-source payload: unhealthy while any objective burns
        (what flips ``/healthz`` to 503 with the burning objective
        named in the body)."""
        report = self.evaluate()
        burning = sorted(n for n, s in report.items() if s["burning"])
        return {
            "healthy": not burning,
            "burning": burning,
            "objectives": report,
        }

    def register_as_health_source(self, name: str = "slo") -> "SloMonitor":
        from tpudl_torch.obs import exporter as obs_exporter

        obs_exporter.register_health_source(name, self.health)
        return self
