"""Async checkpoint writer: bounded on-step stall, background IO (the
port's counterpart of tpudl.ft.writer).

The step path pays only for (a) back-pressure, if the previous save has
not committed yet — at most ONE save is in flight — and (b) the
snapshot to host memory, which the manager takes before it submits.
Serialization, fsync, the atomic commit and retention happen on one
persistent daemon writer thread, overlapped with training.

Obs accounting: the background write records under ``CAT_CKPT_BG``
when a span recorder is active; the ``checkpoint_write_s`` histogram
and the ``checkpoint_saves`` counter of tpudl_torch.obs.counters are
kept either way. A write failure is NOT swallowed: it is re-raised on
the next ``submit``/``wait``/``close``, so the training loop finds
out before it relies on a checkpoint that never landed. ``health``
(sticky: a failed write stays visible after it was re-raised) is the
``checkpoint_writer`` source of /healthz (tpudl_torch.obs.exporter).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from tpudl_torch.ft.store import CheckpointStore
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import spans as obs_spans


class AsyncCheckpointWriter:
    """Single-slot background writer over a CheckpointStore."""

    def __init__(self, store: CheckpointStore):
        self._store = store
        self._lock = threading.Lock()
        self._job_ready = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._job: Optional[tuple] = None
        self._busy = False
        self._error: Optional[BaseException] = None
        # Unlike _error (cleared once re-raised on the step path), the
        # health view of a write failure is sticky.
        self._last_error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="tpudl-ckpt-writer", daemon=True)
        self._thread.start()
        from tpudl_torch.obs import exporter as obs_exporter

        obs_exporter.register_health_source("checkpoint_writer", self.health)

    def health(self) -> dict:
        with self._lock:
            err = self._last_error
            return {
                "healthy": err is None,
                "error": None if err is None
                else f"{type(err).__name__}: {err}",
                "in_flight": self._busy or self._job is not None,
                "closed": self._closed,
            }

    # -- step-path API -------------------------------------------------

    def submit(self, step: int, leaves: List[Tuple[str, object]],
               extra_meta: Optional[dict] = None,
               delay_hook: Optional[Callable[[], None]] = None) -> float:
        """Queue one payload of host leaves. Blocks (back-pressure) while
        a previous save is still being written; raises any deferred
        writer error. Returns the seconds spent blocked (the caller's
        save span accounts them)."""
        waited = 0.0
        with self._lock:
            self._raise_deferred_locked()
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            if self._busy or self._job is not None:
                t0 = time.monotonic()
                while self._busy or self._job is not None:
                    self._idle.wait()
                waited = time.monotonic() - t0
            self._raise_deferred_locked()
            self._job = (step, leaves, extra_meta, delay_hook)
            self._busy = True
            self._job_ready.notify()
        return waited

    def wait(self) -> None:
        """Block until no save is in flight; raise any deferred error."""
        with self._lock:
            while self._busy or self._job is not None:
                self._idle.wait()
            self._raise_deferred_locked()

    def close(self) -> None:
        """Drain, stop the thread, and surface any deferred error."""
        with self._lock:
            if self._closed:
                self._raise_deferred_locked()
                return
            while self._busy or self._job is not None:
                self._idle.wait()
            self._closed = True
            self._job_ready.notify()
        self._thread.join(timeout=30.0)
        with self._lock:
            self._raise_deferred_locked()

    @property
    def in_flight(self) -> bool:
        with self._lock:
            return self._busy or self._job is not None

    def _raise_deferred_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed (deferred from the writer "
                "thread)") from err

    # -- writer thread -------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._job is None and not self._closed:
                    self._job_ready.wait()
                if self._job is None and self._closed:
                    return
                step, leaves, extra_meta, delay_hook = self._job
                self._job = None
            try:
                rec = obs_spans.active_recorder()
                clock = time.monotonic if rec is None else rec.clock
                t0 = clock()
                committed = self._store.write(
                    step, leaves, extra_meta=extra_meta,
                    delay_hook=delay_hook)
                self._store.retain()
                dur = clock() - t0
                reg = obs_counters.registry()
                reg.histogram("checkpoint_write_s").observe(dur)
                if rec is not None:
                    rec.record("checkpoint_write", obs_spans.CAT_CKPT_BG,
                               t0, dur, {"step": step, "committed": committed})
                if committed:
                    reg.counter("checkpoint_saves").inc()
            except BaseException as e:  # deferred to the step path
                with self._lock:
                    self._error = e
                    self._last_error = e
            finally:
                # Drop the host copies before the writer goes idle.
                leaves = None
                with self._lock:
                    self._busy = False
                    self._idle.notify_all()
