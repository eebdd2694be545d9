"""Preemption handling: a SIGTERM/SIGINT grace-window protocol (the
port's counterpart of tpudl.ft.preemption).

Preemption of a spot machine (and any orchestrator drain) delivers
SIGTERM and gives the process a bounded grace window before SIGKILL.
The handler here turns that into a COOPERATIVE shutdown:

1. ``install()`` (or the ``PreemptionGuard`` context manager) registers
   handlers for SIGTERM/SIGINT;
2. on signal, a flag flips (``requested()`` — one Event.is_set per
   step, free) and a daemon watchdog timer starts counting down the
   grace window (``TPUDL_FT_GRACE_S``, default 15s);
3. the train loop (tpudl_torch.train.loop.fit checks the flag every
   step) stops pulling batches, writes an EMERGENCY checkpoint through its
   manager, and returns with ``info["preempted"] = True`` — the worker
   then exits cleanly and the supervisor/launcher resumes it elsewhere;
4. if the cooperative path wedges (a hung collective, a stuck writer),
   the watchdog hard-exits with code 143 (128+SIGTERM) when the grace
   window closes — the committed-checkpoint store guarantees nothing
   torn becomes visible.

Stdlib only; signal handlers install from the MAIN thread (a Python
constraint) — a spawned worker runs its payload on its main thread, so
installing inside the payload is correct.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Iterable, Optional

from tpudl_torch.analysis.registry import env_float

#: Exit code of a hard grace-window exit (128 + SIGTERM) — launchers
#: classify it as preemption, not a crash.
PREEMPTED_EXIT_CODE = 143

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

_requested = threading.Event()
# RLock, not Lock: the signal handler runs ON the main thread's stack
# and may interrupt uninstall()/reset() while they hold this very lock
# — a non-reentrant lock would self-deadlock the process right when
# the grace window should be arming.
_lock = threading.RLock()
_watchdog: Optional[threading.Timer] = None
_deadline: Optional[float] = None
_installed: dict = {}


def default_grace_s() -> float:
    return env_float("TPUDL_FT_GRACE_S", 15.0)


def requested() -> bool:
    """Has a preemption signal arrived? One Event.is_set — cheap enough
    for every train step."""
    return _requested.is_set()


def remaining_grace() -> Optional[float]:
    """Seconds left in the grace window, None before any signal."""
    if _deadline is None:
        return None
    return max(0.0, _deadline - time.monotonic())


def _on_signal(grace_s: float, signum, frame) -> None:
    global _deadline
    first = not _requested.is_set()
    _requested.set()
    if not first:
        return  # repeated signals don't restack watchdogs
    with _lock:
        _deadline = time.monotonic() + grace_s
        global _watchdog
        _watchdog = threading.Timer(
            grace_s, os._exit, args=(PREEMPTED_EXIT_CODE,)
        )
        _watchdog.daemon = True
        _watchdog.start()


def install(
    grace_s: Optional[float] = None,
    signals: Iterable[int] = _DEFAULT_SIGNALS,
) -> None:
    """Register the grace-window handlers (idempotent; main thread
    only). Previously-registered handlers are remembered for
    ``uninstall``."""
    if grace_s is None:
        grace_s = default_grace_s()
    for sig in signals:
        if sig not in _installed:
            _installed[sig] = signal.getsignal(sig)
        signal.signal(
            sig, lambda signum, frame: _on_signal(grace_s, signum, frame)
        )


def uninstall() -> None:
    """Restore prior handlers, disarm the watchdog, and CLEAR the
    requested flag — the flag's lifetime is the installation's. A
    sticky flag would make every later fit() in the same process
    (a notebook re-run, a second training phase) return 0 steps as
    'preempted'."""
    global _deadline
    for sig, prev in _installed.items():
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):
            pass
    _installed.clear()
    _requested.clear()
    with _lock:
        global _watchdog
        if _watchdog is not None:
            _watchdog.cancel()
            _watchdog = None
        _deadline = None


def reset() -> None:
    """Clear the requested flag and disarm the watchdog (tests; a
    supervisor reusing a process)."""
    global _deadline
    _requested.clear()
    with _lock:
        global _watchdog
        if _watchdog is not None:
            _watchdog.cancel()
            _watchdog = None
        _deadline = None


class PreemptionGuard:
    """``with PreemptionGuard(grace_s=30):`` — install on entry, restore
    handlers + disarm the watchdog on exit. The guard exiting means the
    cooperative path completed (emergency checkpoint committed), so the
    hard-exit watchdog must not fire afterwards."""

    def __init__(
        self,
        grace_s: Optional[float] = None,
        signals: Iterable[int] = _DEFAULT_SIGNALS,
    ):
        self._grace_s = grace_s
        self._signals = tuple(signals)

    def __enter__(self) -> "PreemptionGuard":
        install(self._grace_s, self._signals)
        return self

    def __exit__(self, *exc) -> None:
        uninstall()

    @staticmethod
    def preempted() -> bool:
        return requested()
