"""Fault injection: the port's counterpart of tpudl.ft.chaos, the
harness that makes fault tolerance a tested property instead of a hope.

Three injectors, all env-gated so a spawned worker picks them up without
code changes:

- **Worker kill** (``step_kill_hook``): SIGKILL this process when the
  training step counter crosses ``TPUDL_CHAOS_KILL_AT_STEP`` —
  optionally only on rank ``TPUDL_CHAOS_KILL_RANK`` — exactly ONCE per
  ``TPUDL_CHAOS_ONCE_DIR`` (a marker file on the shared filesystem, so
  the supervisor-restarted cohort does not die forever).
- **Checkpoint truncation** (``truncate_checkpoint`` /
  ``remove_commit_marker``): corrupt a committed payload or strip a
  commit marker, driving the restore-fallback and
  uncommitted-invisible paths.
- **IO delay** (``TPUDL_CHAOS_IO_DELAY_S`` via ``io_delay_hook``): the
  background writer sleeps that long before bytes land — a
  deterministic "slow disk" for back-pressure and bounded-stall tests.

Kills are raw SIGKILL on purpose: no atexit, no flushes, no Python
teardown — the same failure shape as an OOM kill or a yanked node.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional

from tpudl_torch.analysis.registry import env_float, env_int, env_str
from tpudl_torch.ft.store import COMMIT_MARKER, PAYLOAD_FILE, CheckpointStore

ENV_KILL_AT_STEP = "TPUDL_CHAOS_KILL_AT_STEP"
ENV_KILL_RANK = "TPUDL_CHAOS_KILL_RANK"
ENV_ONCE_DIR = "TPUDL_CHAOS_ONCE_DIR"
ENV_IO_DELAY_S = "TPUDL_CHAOS_IO_DELAY_S"


# ---------------------------------------------------------------------------
# worker kill
# ---------------------------------------------------------------------------


def kill_self() -> None:
    """SIGKILL the current process — no cleanup, like the real thing."""
    os.kill(os.getpid(), signal.SIGKILL)


def step_killer(
    kill_at_step: int,
    rank: Optional[int] = None,
    once_dir: Optional[str] = None,
) -> Callable[[int], None]:
    """A ``hook(step)`` that kills this process the first time ``step >=
    kill_at_step``. ``rank`` gates on TPUDL_PROCESS_ID; ``once_dir``
    holds the fired-once marker shared across restarts."""

    def hook(step: int) -> None:
        if step < kill_at_step:
            return
        me = env_int("TPUDL_PROCESS_ID", 0)
        if rank is not None and me != rank:
            return
        if once_dir is not None:
            # One marker PER RANK: a cohort-wide kill (rank=None) takes
            # every worker down once, and none of them dies again after
            # the supervisor restarts the cohort.
            marker = os.path.join(once_dir, f"chaos_killed_p{me}")
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return
        kill_self()

    return hook


def step_kill_hook() -> Optional[Callable[[int], None]]:
    """Env-driven ``step_killer`` for spawned workers; None when chaos
    is off (the default)."""
    kill_at = env_int(ENV_KILL_AT_STEP)
    if kill_at is None:
        return None
    return step_killer(
        kill_at,
        rank=env_int(ENV_KILL_RANK),
        once_dir=env_str(ENV_ONCE_DIR),
    )


# ---------------------------------------------------------------------------
# checkpoint corruption
# ---------------------------------------------------------------------------


def truncate_checkpoint(
    directory: str, step: Optional[int] = None, keep_bytes: int = 16
) -> int:
    """Truncate the committed payload of ``step`` (default: latest) to
    ``keep_bytes`` — bit-rot/partial-flush simulation AFTER commit.
    Returns the corrupted step."""
    store = CheckpointStore(directory)
    if step is None:
        step = store.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(store.step_dir(step), PAYLOAD_FILE)
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    return step


def remove_commit_marker(directory: str, step: int) -> None:
    """Strip a commit marker — the checkpoint must become invisible to
    latest_step/restore."""
    store = CheckpointStore(directory)
    os.remove(os.path.join(store.step_dir(step), COMMIT_MARKER))


# ---------------------------------------------------------------------------
# IO delay
# ---------------------------------------------------------------------------


def io_delay_s() -> float:
    return env_float(ENV_IO_DELAY_S, 0.0)


def io_delay_hook() -> Optional[Callable[[], None]]:
    """A writer-side delay hook when TPUDL_CHAOS_IO_DELAY_S is set,
    else None (read per save, so tests can flip it mid-run)."""
    delay = io_delay_s()
    if delay <= 0:
        return None

    def hook() -> None:
        time.sleep(delay)

    return hook
