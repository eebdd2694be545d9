"""Supervised restart: the layer between "a worker died" and "the run
finished anyway" (the port's counterpart of tpudl.ft.supervisor).

``Supervisor`` wraps anything with a ``run(fn, *args, **kwargs)`` that
raises when the run fails — tpudl's ``TpuDistributor``; the port's
launcher is ROADMAP queue A item 7, so until then a caller's own
runner (``chip_smoke.py`` has a one-process one). When the run fails
(worker SIGKILLed, nonzero exit, Python exception, timeout), it waits
an exponential backoff and relaunches the WHOLE run under a retry
budget. Restart state does not live in the supervisor: the payload must
be RESUME-IDEMPOTENT, i.e. begin with ``tpudl_torch.ft.resume_run`` (or
``resume_latest``) against the shared checkpoint directory, so attempt
N+1 continues from the newest committed checkpoint instead of step 0.
That contract — plus the full-resume-state payload (step, RNG seed,
data position) — makes the restarted run schedule-identical to an
uninterrupted one.

Obs: every restart increments ``ft_restarts``; the failure-to-relaunch
gap records as a ``recovery``-category span; the last failure detail
rides a ``worker_failure`` event.

Knobs (env defaults, constructor overrides):
``TPUDL_FT_MAX_RESTARTS`` (default 3), ``TPUDL_FT_BACKOFF_S`` (initial
backoff, default 1.0), ``TPUDL_FT_MAX_BACKOFF_S`` (cap, default 30).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from tpudl_torch.analysis import registry
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import spans as obs_spans


class SupervisorGaveUp(RuntimeError):
    """The retry budget is exhausted; the last cohort failure chains as
    ``__cause__``."""

    def __init__(self, attempts: int, msg: str):
        super().__init__(msg)
        self.attempts = attempts


def _env_float(name: str, default: float) -> float:
    return registry.env_float(name, default)


def _env_int(name: str, default: int) -> int:
    return registry.env_int(name, default)


@dataclasses.dataclass
class RestartPolicy:
    """Retry budget + exponential backoff (env-seeded defaults)."""

    max_restarts: int = dataclasses.field(
        default_factory=lambda: _env_int("TPUDL_FT_MAX_RESTARTS", 3)
    )
    backoff_s: float = dataclasses.field(
        default_factory=lambda: _env_float("TPUDL_FT_BACKOFF_S", 1.0)
    )
    backoff_factor: float = 2.0
    max_backoff_s: float = dataclasses.field(
        default_factory=lambda: _env_float("TPUDL_FT_MAX_BACKOFF_S", 30.0)
    )

    def backoff(self, restart_index: int) -> float:
        """Backoff before restart #restart_index (1-based)."""
        return min(
            self.max_backoff_s,
            self.backoff_s * self.backoff_factor ** (restart_index - 1),
        )


class Supervisor:
    """Restart wrapper around a runner with ``run(fn, *args, **kwargs)``
    (see the module docstring)."""

    def __init__(
        self,
        distributor,
        policy: Optional[RestartPolicy] = None,
        restartable: Optional[Callable[[BaseException], bool]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        """``restartable`` filters failures worth retrying (default: any
        RuntimeError — a runner's failed-run type; a programming
        TypeError should fail fast). ``sleep`` is
        injectable for tests."""
        self.distributor = distributor
        self.policy = policy or RestartPolicy()
        self._restartable = restartable or (
            lambda e: isinstance(e, RuntimeError)
        )
        self._sleep = sleep
        self.restarts = 0
        self.failures: List[str] = []

    def run(self, fn: Callable, *args: Any, **kwargs: Any) -> List[Any]:
        """Run the cohort to completion, restarting on failure up to the
        retry budget. Returns the successful attempt's rank-ordered
        results; raises SupervisorGaveUp past the budget."""
        rec = obs_spans.active_recorder()
        reg = obs_counters.registry()
        attempt = 0
        run_restarts = 0  # per-call; self.restarts is the lifetime total
        while True:
            attempt += 1
            try:
                results = self.distributor.run(fn, *args, **kwargs)
                if run_restarts:
                    reg.counter("ft_recovered_runs").inc()
                return results
            except BaseException as e:
                if not self._restartable(e):
                    raise
                detail = f"{type(e).__name__}: {e}"
                self.failures.append(detail)
                if rec is not None:
                    rec.event(
                        "worker_failure", obs_spans.CAT_RECOVERY,
                        attempt=attempt, detail=detail[:2000],
                    )
                if attempt > self.policy.max_restarts:
                    raise SupervisorGaveUp(
                        attempt,
                        f"cohort failed {attempt} time(s); retry budget "
                        f"({self.policy.max_restarts} restarts) "
                        f"exhausted. Last failure: {detail}",
                    ) from e
                run_restarts += 1
                self.restarts += 1
                reg.counter("ft_restarts").inc()
                backoff = self.policy.backoff(run_restarts)
                t0 = rec.clock() if rec is not None else None
                self._sleep(backoff)
                if rec is not None:
                    # Lost-to-recovery wall-clock in the supervising
                    # process: the backoff gap between cohort death and
                    # relaunch. (The failed attempt's own worker spans
                    # were already merged into the stream by the
                    # distributor and classify per-rank.)
                    rec.record(
                        "recovery_backoff", obs_spans.CAT_RECOVERY, t0,
                        rec.clock() - t0,
                        {"attempt": attempt, "backoff_s": backoff},
                    )


def resume_run(
    manager,
    state,
    batches=None,
    mesh=None,
    rules=None,
):
    """The resume-idempotent payload prologue: restore the newest
    committed checkpoint (full resume state) if one exists and
    fast-forward the data.

    Returns ``(state, rng, batches, start_step)`` — on a cold start
    ``(state, None, batches, 0)`` untouched, so one call site serves
    both the first launch and every supervised restart::

        state, rng, batches, start = resume_run(mgr, state, batches)
        rng = rng if rng is not None else seed
        fit(step, state, batches, rng,
            num_steps=total - start, checkpoint_manager=mgr, ...)

    ``batches``: a ``tpudl_torch.ft.ResumableIterator`` seeks to the saved
    (epoch, offset); any other iterable is WRAPPED in one and seeked
    (single-epoch sources only — a multi-epoch position demands an
    epoch factory), so the returned iterator keeps reporting its
    position and the NEXT restart fast-forwards too. The wrap happens
    on cold starts as well — a plain-iterable run records its data
    position from launch one. None is passed through. The state is
    restored IN PLACE (a state a compiled step captured stays valid);
    ``mesh`` / ``rules`` raise NotImplementedError (ROADMAP queue A
    item 7).
    """
    from tpudl_torch.ft.data import ResumableIterator

    if batches is not None and not isinstance(batches, ResumableIterator):
        batches = ResumableIterator(batches)
    latest = manager.latest_step()
    if latest is None:
        return state, None, batches, 0
    if hasattr(manager, "restore_full"):
        state, rng, data_state = manager.restore_full(
            state, mesh=mesh, rules=rules
        )
    else:
        state = manager.restore(state, mesh=mesh, rules=rules)
        rng, data_state = None, None
    start_step = int(state.step)
    if batches is not None and data_state:
        batches.seek(data_state)
    return state, rng, batches, start_step
