"""Two-stage pipelined host->device prefetch with data-wait autotuning:
the port's counterpart of tpudl.data.prefetch.

The feed runs in two stages with bounded queues between them:

- **assembly stage**: a pool of workers pulls batches from the source
  iterator (one at a time, under a lock: sources are often generators)
  and applies the host ``transform`` OUTSIDE the lock, so N workers
  overlap N transforms (augmentation, dtype casts). A sequence ticket
  restores source order at the next stage, so any worker count yields
  the exact single-threaded batch sequence; a ticket window bounds how
  far ahead of the transfer stage the pool may run, so one straggling
  transform cannot let its peers stream the remaining source into host
  memory. Threads overlap only where the transform leaves the
  interpreter lock: numpy copies of large arrays and the native
  augmenter (tpudl_torch.data.native, called through ``ctypes``) do.
- **transfer stage**: one thread copies each host batch into pinned host
  memory and from there to the card on a side stream of its own, and
  records an event after the copies; the consumer's stream waits on that
  event when it takes the batch (no host wait), and the batch's tensors
  are marked as used by the consumer's stream so the allocator does not
  hand their memory out while the step still reads it. With queue depth
  >= 2 the pipeline is double-buffered: one batch copying while the
  previous one is consumed. On a CPU ``device`` the stage hands over
  plain tensors.

Failure semantics:

- a worker exception is stored and BOTH queues are closed immediately,
  so the consumer raises on its very next pull, not after draining every
  batch already queued;
- ``close()`` (also called on source exhaustion, on context-manager
  exit, and, via ``weakref.finalize``, when the consumer handle is
  garbage-collected or the process exits) wakes every blocked
  ``put``/``get`` and joins the workers, so a consumer that ``break``s
  out early leaks no thread blocked on a full queue. The worker threads
  reference only the internal ``_Pipeline`` state, never the consumer
  handle, so dropping the handle makes it collectable.

Autotuning: ``PrefetchAutotuner`` watches the consumer-side data wait and
grows the staged depth while the windowed p95 exceeds a threshold,
within a byte budget. ``TPUDL_PREFETCH_DEPTH`` pins the depth and
disables autotuning.

Not ported: a mesh (tpudl's per-process shards of a global batch, ROADMAP
queue A item 7) and ``window`` > 1 (the stacked feed of the fused K-step
dispatch, item 10); both raise.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from tpudl_torch.analysis.registry import env_int
from tpudl_torch.obs.counters import percentile

#: Default ceiling on autotuned staged depth.
DEFAULT_MAX_DEPTH = 8
#: Default budget for staged batches (bytes of HOST batch per slot x
#: depth). 256 MiB: ~2.6 ImageNet uint8 1024-image batches.
DEFAULT_BYTE_BUDGET = 256 << 20
#: Default data-wait p95 threshold above which depth grows.
DEFAULT_TARGET_WAIT_S = 0.002

_END = object()  # transfer -> consumer: source exhausted


class _Closed(Exception):
    """Internal: raised by queue put/get after close(); unwinds workers."""


class _BoundedQueue:
    """Bounded FIFO whose capacity can grow at runtime (the autotuner's
    lever) and whose ``close()`` wakes every blocked producer AND
    consumer. ``get`` drains remaining items after close; ``put``
    raises."""

    def __init__(self, capacity: int):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._items: collections.deque = collections.deque()
        self._capacity = max(1, int(capacity))
        self._closed = False

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, n: int) -> None:
        with self._lock:
            self._capacity = max(1, int(n))
            self._not_full.notify_all()

    def put(self, item) -> None:
        with self._not_full:
            while len(self._items) >= self._capacity and not self._closed:
                self._not_full.wait()
            if self._closed:
                raise _Closed
            self._items.append(item)
            self._not_empty.notify()

    def get(self):
        with self._not_empty:
            while not self._items and not self._closed:
                self._not_empty.wait()
            if self._items:
                item = self._items.popleft()
                self._not_full.notify()
                return item
            raise _Closed  # closed and drained

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()


class PrefetchAutotuner:
    """Grow prefetch depth while the data-wait p95 says the consumer is
    starved, within a byte budget.

    Every ``window`` observations of the consumer's per-pull wait it
    takes the window's p95; above ``target_wait_s`` the depth grows by
    one, capped by ``max_depth`` and by ``depth * host-batch-bytes <=
    byte_budget`` (staged batches are live buffers). Depth never shrinks.
    The first observation (pipeline fill, the step's warm-up) is not
    counted. ``decisions`` keeps ``(observations_seen, old_depth,
    new_depth, p95_s)`` tuples."""

    def __init__(
        self,
        depth: int = 2,
        max_depth: int = DEFAULT_MAX_DEPTH,
        target_wait_s: float = DEFAULT_TARGET_WAIT_S,
        byte_budget: int = DEFAULT_BYTE_BUDGET,
        window: int = 16,
    ):
        if depth < 1 or max_depth < depth:
            raise ValueError(
                f"need 1 <= depth <= max_depth, got {depth}, {max_depth}")
        self.depth = int(depth)
        self.max_depth = int(max_depth)
        self.target_wait_s = float(target_wait_s)
        self.byte_budget = int(byte_budget)
        self.window = max(1, int(window))
        self.decisions: list = []
        self._waits: list = []
        self._seen = 0

    def observe(self, wait_s: float, batch_bytes: Optional[int]) -> int:
        """Record one consumer wait; returns the (possibly grown) depth."""
        self._seen += 1
        if self._seen == 1:
            return self.depth
        self._waits.append(float(wait_s))
        if len(self._waits) < self.window:
            return self.depth
        p95 = percentile(sorted(self._waits), 0.95)
        self._waits.clear()
        if p95 > self.target_wait_s and self.depth < self.max_depth:
            new = self.depth + 1
            if batch_bytes and new * batch_bytes > self.byte_budget:
                return self.depth  # budget-capped
            self.decisions.append((self._seen, self.depth, new, p95))
            self.depth = new
        return self.depth


def _nbytes(batch) -> int:
    if isinstance(batch, dict):
        return sum(_nbytes(v) for v in batch.values())
    if isinstance(batch, torch.Tensor):
        return batch.numel() * batch.element_size()
    return int(getattr(batch, "nbytes", 0))


class _Pipeline:
    """All state the worker threads touch, kept apart from the
    consumer-facing ``DevicePrefetcher`` so the threads never hold a
    reference to the handle (see the module docstring)."""

    def __init__(self, iterator, place, depth, transform, assembly_workers,
                 host_depth):
        self.src = iter(iterator)
        self.src_lock = threading.Lock()
        self.src_done = False
        self.seq = 0
        self.place = place
        self.transform = transform
        self.host_q = _BoundedQueue(host_depth)
        self.device_q = _BoundedQueue(depth)
        self.error: Optional[BaseException] = None
        self.error_lock = threading.Lock()
        self.closed = False
        self.last_host_bytes: Optional[int] = None
        self.live_assemblers = assembly_workers
        # Ticket window: a worker holding ticket `seq` parks (before its
        # transform) until seq < emitted + max_ahead, which caps the
        # batches held on the host at ~(workers + host_depth + max_ahead).
        # Ticket `emitted` itself is never parked, so progress is
        # deadlock-free.
        self.emitted = 0
        self.ahead = threading.Condition()
        self.max_ahead = host_depth + assembly_workers + depth
        self.threads = [
            threading.Thread(target=self.assemble,
                             name=f"tpudl-torch-prefetch-assembly-{i}",
                             daemon=True)
            for i in range(assembly_workers)
        ]
        self.threads.append(threading.Thread(
            target=self.transfer, name="tpudl-torch-prefetch-transfer",
            daemon=True))
        for t in self.threads:
            t.start()

    def fail(self, e: BaseException) -> None:
        with self.error_lock:
            if self.error is None:
                self.error = e
        # Every blocked producer and consumer wakes now: the consumer's
        # next pull raises instead of draining stale batches first.
        self.host_q.close()
        self.device_q.close()
        with self.ahead:
            self.ahead.notify_all()

    def assemble(self) -> None:
        try:
            while True:
                with self.src_lock:
                    if self.src_done:
                        return
                    try:
                        batch = next(self.src)
                    except StopIteration:
                        self.src_done = True
                        return
                    seq = self.seq
                    self.seq += 1
                with self.ahead:
                    while (seq >= self.emitted + self.max_ahead
                           and not self.closed and self.error is None):
                        self.ahead.wait()
                    if self.closed or self.error is not None:
                        return
                if self.transform is not None:
                    batch = self.transform(batch)
                self.host_q.put((seq, batch))
        except _Closed:
            pass
        except BaseException as e:  # propagate promptly to the consumer
            self.fail(e)
        finally:
            with self.src_lock:
                self.live_assemblers -= 1
                last = self.live_assemblers == 0
                total = self.seq
            if last:
                try:
                    self.host_q.put((_END, total))
                except _Closed:
                    pass

    def transfer(self) -> None:
        pending: dict = {}
        emit = 0
        total = None
        try:
            while True:
                while emit in pending:
                    batch = pending.pop(emit)
                    emit += 1
                    with self.ahead:
                        self.emitted = emit
                        self.ahead.notify_all()
                    self.last_host_bytes = _nbytes(batch)
                    self.device_q.put(self.place(batch))
                if total is not None and emit >= total:
                    self.device_q.put(_END)
                    return
                item = self.host_q.get()
                if item[0] is _END:
                    total = item[1]
                else:
                    pending[item[0]] = item[1]
        except _Closed:
            pass
        except BaseException as e:
            self.fail(e)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.host_q.close()
        self.device_q.close()
        with self.ahead:
            self.ahead.notify_all()
        for t in self.threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)


def _host_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _placer(device: torch.device) -> Callable[[Dict], tuple]:
    """The transfer stage's copy: ``batch -> (device batch, event)``. On
    the card: pinned staging, an H2D copy on a side stream, an event
    after it; on the CPU: tensors and no event."""
    if device.type != "cuda":
        return lambda batch: ({k: _host_tensor(v).to(device)
                               for k, v in batch.items()}, None)
    stream = torch.cuda.Stream(device=device)

    def place(batch: Dict) -> tuple:
        with torch.cuda.stream(stream):
            out = {}
            for k, v in batch.items():
                host = _host_tensor(v)
                if not host.is_cuda:
                    # The pinned copy stays alive until the H2D copy that
                    # reads it has run (the host allocator records it).
                    host = host.pin_memory()
                out[k] = host.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    return place


class DevicePrefetcher:
    """Two-stage pipelined prefetch iterator (see the module docstring)
    over device batches (dicts of tensors) in exact source order.
    ``close()`` is idempotent; iterating after close raises
    StopIteration. Use as a context manager or drain it; abandonment is
    reaped by a ``weakref.finalize`` on this handle. ``waits`` holds each
    pull's data wait in seconds."""

    def __init__(
        self,
        iterator: Iterator[Dict],
        mesh=None,
        depth: int = 2,
        transform: Optional[Callable[[Dict], Dict]] = None,
        assembly_workers: int = 1,
        autotuner: Optional[PrefetchAutotuner] = None,
        host_depth: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        window: int = 1,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "prefetch_to_device(mesh=...) is not ported to tpudl_torch "
                "yet (ROADMAP queue A item 7)")
        if assembly_workers < 1:
            raise ValueError(
                f"assembly_workers must be >= 1, got {assembly_workers}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window > 1:
            raise NotImplementedError(
                f"prefetch_to_device(window={window}) (the fused K-step "
                f"feed) is not ported to tpudl_torch yet (ROADMAP queue A "
                f"item 10)")
        depth = max(1, int(depth))
        if autotuner is not None:
            autotuner.depth = max(autotuner.depth, depth)
        self.device = torch.device(device)
        self._autotuner = autotuner
        self._clock = clock
        self.waits: list = []
        self._p = _Pipeline(
            iterator, _placer(self.device), depth, transform,
            assembly_workers,
            host_depth if host_depth is not None else assembly_workers + 2)
        # The callback holds only the pipeline, so it cannot keep the
        # handle alive.
        self._finalizer = weakref.finalize(self, self._p.close)

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def _raise_error(self):
        err = self._p.error
        self.close()
        if isinstance(err, StopIteration):
            # Re-raised from __next__ it would read as clean exhaustion.
            raise RuntimeError("prefetch worker raised StopIteration") from err
        raise err

    def __next__(self) -> Dict[str, torch.Tensor]:
        if self._p.error is not None:
            self._raise_error()
        if self._p.closed:
            raise StopIteration
        t0 = self._clock()
        try:
            item = self._p.device_q.get()
        except _Closed:
            if self._p.error is not None:
                self._raise_error()
            raise StopIteration
        wait = self._clock() - t0
        if self._p.error is not None:
            # An already-recorded worker failure surfaces on THIS pull.
            self._raise_error()
        if item is _END:
            self.close()
            raise StopIteration
        self.waits.append(wait)
        if self._autotuner is not None:
            new_depth = self._autotuner.observe(wait, self._p.last_host_bytes)
            if new_depth != self._p.device_q.capacity:
                self._p.device_q.set_capacity(new_depth)
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    @property
    def window(self) -> int:
        return 1

    @property
    def depth(self) -> int:
        """Current staged-queue capacity (grows under autotuning)."""
        return self._p.device_q.capacity

    def close(self) -> None:
        """Stop both stages, wake every blocked put/get, join the workers.
        Workers blocked inside the source iterator cannot be interrupted:
        they are daemons, and the join is bounded."""
        self._finalizer()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(
    iterator: Iterator[Dict],
    mesh=None,
    prefetch: int = 2,
    *,
    transform: Optional[Callable[[Dict], Dict]] = None,
    assembly_workers: int = 1,
    autotune: Optional[bool] = None,
    max_depth: int = DEFAULT_MAX_DEPTH,
    byte_budget: int = DEFAULT_BYTE_BUDGET,
    target_wait_s: float = DEFAULT_TARGET_WAIT_S,
    window: int = 1,
    device="cuda",
) -> DevicePrefetcher:
    """Overlap host batch assembly and the host-to-card copy with the
    card's work (tpudl's ``prefetch_to_device``).

    ``assembly_workers`` host threads apply ``transform`` and feed one
    transfer thread; up to ``prefetch`` batches stay staged on
    ``device``. Pass the per-batch host work (augmentation, casts) as
    ``transform`` HERE rather than inside the source iterator: source
    pulls serialize under a lock, transforms run in parallel across the
    pool. ``autotune`` (default: on) grows the staged depth toward
    ``max_depth`` while the consumer's data-wait p95 exceeds
    ``target_wait_s``, within ``byte_budget`` bytes of staged batches.
    ``TPUDL_PREFETCH_DEPTH`` pins the depth and disables autotuning.
    ``mesh`` and ``window`` > 1 raise (see the module docstring).

    Returns a ``DevicePrefetcher``: an iterator of dicts of tensors on
    ``device`` with ``close()`` (and context-manager support)."""
    env_depth = env_int("TPUDL_PREFETCH_DEPTH")
    autotuner = None
    if env_depth is not None:
        prefetch = max(1, env_depth)
    elif autotune or autotune is None:
        autotuner = PrefetchAutotuner(
            depth=max(1, prefetch), max_depth=max(max_depth, prefetch),
            target_wait_s=target_wait_s, byte_budget=byte_budget)
    return DevicePrefetcher(
        iterator, mesh=mesh, depth=prefetch, transform=transform,
        assembly_workers=assembly_workers, autotuner=autotuner,
        window=window, device=device)
