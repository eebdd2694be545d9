"""Serving-fleet fault injection: the chaos harness that makes the
failover/migration paths a TESTED property instead of a hope.

A copy of tpudl.serve.chaos (stdlib only; the port keeps its own), less
its scrape faults: ``make_scrape_fault`` / ``install_scrape_chaos`` and
their ``TPUDL_SERVE_CHAOS_SCRAPE_*`` knobs feed tpudl's FleetMonitor,
which comes with the router and its replicas (ROADMAP queue A item
16(c)). ``tpudl_torch.ft.chaos`` holds the same doctrine for training —
a recovery path that is never exercised is a liability — and this module
applies it to serving, riding the same env-gated once-marker idiom so
an engine picks the faults up without code changes:

- **Replica kill** (``step_killer`` / ``TPUDL_SERVE_CHAOS_KILL_STEP``):
  raise ``ChaosKill`` inside ``Engine.step`` at decode step N — the
  loop driving the engine dies exactly like a real engine fault
  (tpudl's replica loop then publishes unhealthy and the router fails
  its work over; the KV is GONE, so this exercises the resubmit
  fallback, not migration).
- **Replica preempt** (``step_preempter`` /
  ``TPUDL_SERVE_CHAOS_PREEMPT_STEP``): raise ``ChaosPreempt`` at step
  N, the serving analog of a node preemption notice. The hooks run at
  the top of ``Engine.step``, before any of the step's work, so the
  engine's state stays whole: whoever drives the engine catches it and
  MIGRATES every seated request (``Engine.export_request``, then
  ``install_migrated`` on a survivor) with zero re-prefill. In tpudl
  that is the replica loop (lame duck: scrapes unready, the thread
  answers the router's migration pull; item 16(c) here).
- **Engine freeze** (``step_freezer`` /
  ``TPUDL_SERVE_CHAOS_FREEZE_STEP`` + ``_FREEZE_S``): sleep T seconds
  inside ``Engine.step``, holding the whole serving loop — the
  stale-heartbeat path (tpudl's ``Replica(stale_after_s=...)`` flips
  unready, export times out, the router falls back to resubmission;
  when the freeze ends the replica publishes again and rejoins).
- **Migration payload corruption** (``corrupt_payload`` /
  ``TPUDL_SERVE_CHAOS_FLIP_MIGRATION``): flip one bit of a migration
  payload in transfer; with the knob set, every payload an engine
  receives (``install_migrated``, the ``migrate_inbox``) is flipped.
  The crc32 MUST catch it: the request sheds as ``failed``, and is
  never resumed silently.

Once-markers (``TPUDL_SERVE_CHAOS_ONCE_DIR``) make a fault fire
exactly once per marker directory across every engine in the process —
"kill ONE replica of the fleet", not all three. Hooks also latch
locally so a fired injector never re-fires in its own engine.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional

from tpudl_torch.analysis.registry import env_flag, env_float, env_int, env_str

ENV_KILL_STEP = "TPUDL_SERVE_CHAOS_KILL_STEP"
ENV_PREEMPT_STEP = "TPUDL_SERVE_CHAOS_PREEMPT_STEP"
ENV_FREEZE_STEP = "TPUDL_SERVE_CHAOS_FREEZE_STEP"
ENV_FREEZE_S = "TPUDL_SERVE_CHAOS_FREEZE_S"
ENV_ONCE_DIR = "TPUDL_SERVE_CHAOS_ONCE_DIR"
ENV_FLIP_MIGRATION = "TPUDL_SERVE_CHAOS_FLIP_MIGRATION"


class ChaosKill(RuntimeError):
    """Injected engine fault: the loop driving the engine must DIE (a crashed
    replica — migration payloads unavailable)."""


class ChaosPreempt(RuntimeError):
    """Injected preemption notice: the engine must leave service, its
    seated requests exported to survivors (``Engine.export_request``)."""


def claim_once(once_dir: Optional[str], tag: str) -> bool:
    """Claim the ``tag`` marker in ``once_dir`` (atomic O_EXCL, the
    ft.chaos idiom): True for exactly ONE claimant per directory —
    how "kill one replica" stays one replica when every engine in the
    process carries the same env-driven hook. ``once_dir=None`` always
    claims (single-engine/programmatic use)."""
    if once_dir is None:
        return True
    marker = os.path.join(once_dir, f"chaos_{tag}")
    try:
        fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
        return True
    except FileExistsError:
        return False


def _at_step(at_step: int, once_dir: Optional[str], tag: str,
             fire: Callable[[], None]) -> Callable[[int], None]:
    """One-shot engine-step hook: ``fire()`` the first time the step
    counter reaches ``at_step`` AND the once-marker is claimed; latch
    locally so this engine never re-fires."""
    fired = threading.Event()

    def hook(step: int) -> None:
        if fired.is_set() or step < at_step:
            return
        fired.set()
        if not claim_once(once_dir, tag):
            return
        fire()

    return hook


def step_killer(
    kill_at_step: int, once_dir: Optional[str] = None
) -> Callable[[int], None]:
    """Hook that raises ``ChaosKill`` at decode step N — a crashed
    replica thread, KV unrecoverable (resubmit-fallback path)."""

    def fire() -> None:
        raise ChaosKill(f"chaos: replica killed at decode step {kill_at_step}")

    return _at_step(kill_at_step, once_dir, "kill", fire)


def step_preempter(
    preempt_at_step: int, once_dir: Optional[str] = None
) -> Callable[[int], None]:
    """Hook that raises ``ChaosPreempt`` at decode step N — the engine
    leaves service and its seated KV must MIGRATE to survivors."""

    def fire() -> None:
        raise ChaosPreempt(
            f"chaos: replica preempted at decode step {preempt_at_step}"
        )

    return _at_step(preempt_at_step, once_dir, "preempt", fire)


def step_freezer(
    freeze_at_step: int,
    freeze_s: float,
    once_dir: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Callable[[int], None]:
    """Hook that sleeps ``freeze_s`` inside step N — the whole replica
    loop hangs (heartbeat goes stale, exports time out) and then
    resumes as if nothing happened."""
    return _at_step(
        freeze_at_step, once_dir, "freeze", lambda: sleep(freeze_s)
    )


def engine_step_hooks() -> List[Callable[[int], None]]:
    """Env-driven hooks for every Engine constructed in this process;
    empty when chaos is off (the default). Set
    ``TPUDL_SERVE_CHAOS_ONCE_DIR`` so a fleet-wide knob fells exactly
    one replica."""
    hooks: List[Callable[[int], None]] = []
    once_dir = env_str(ENV_ONCE_DIR)
    kill_at = env_int(ENV_KILL_STEP)
    if kill_at is not None:
        hooks.append(step_killer(kill_at, once_dir=once_dir))
    preempt_at = env_int(ENV_PREEMPT_STEP)
    if preempt_at is not None:
        hooks.append(step_preempter(preempt_at, once_dir=once_dir))
    freeze_at = env_int(ENV_FREEZE_STEP)
    if freeze_at is not None:
        hooks.append(
            step_freezer(
                freeze_at,
                env_float(ENV_FREEZE_S, 1.0),
                once_dir=once_dir,
            )
        )
    return hooks


# ---------------------------------------------------------------------------
# migration payload corruption
# ---------------------------------------------------------------------------


def corrupt_payload(payload: bytes, bit: Optional[int] = None) -> bytes:
    """Flip one bit of a migration payload (default: the middle of the
    array region) — the length-preserving corruption a network or DMA
    fault produces. The crc32 MUST catch it at import; a payload that
    resumes anyway is the bug this injector exists to find."""
    if not payload:
        raise ValueError("cannot corrupt an empty payload")
    data = bytearray(payload)
    index = (len(data) // 2) * 8 + 3 if bit is None else int(bit)
    byte, offset = divmod(index, 8)
    data[byte % len(data)] ^= 1 << offset
    return bytes(data)


def maybe_corrupt_migration(payload: bytes) -> bytes:
    """Env-gated transfer corruption (``TPUDL_SERVE_CHAOS_FLIP_MIGRATION``):
    every payload an engine receives passes through here
    (``tpudl_torch.serve.engine._received``)."""
    if payload and env_flag(ENV_FLIP_MIGRATION):
        return corrupt_payload(payload)
    return payload
