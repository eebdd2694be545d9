"""Bounded admission queue: what waits, in what order, and what gets shed.

A copy of tpudl.serve.queue (pure Python; the port keeps its own).

Scheduling policy, in order:

- **aged FIFO promotion** (the priority-starvation guard): if the
  OLDEST waiting entry has waited longer than ``promote_after_s``, it
  is served next regardless of priority — under a sustained stream of
  high-priority arrivals, background work still makes progress with a
  bounded (promote_after_s) wait, instead of starving forever.
- **priority, then FIFO**: entries pop lowest ``priority`` first and
  submission order within a priority level (heap keyed on
  ``(priority, seq)`` — the seq number makes equal-priority ordering
  total and stable).
- **deadlines shed at pop time**: a request whose absolute deadline has
  passed when the engine asks for work is handed back as shed, not
  served — the engine records it as a ``shed_timeout`` Result. Expiry
  is O(expired · log n) off a dedicated min-heap keyed on deadline
  (the old implementation re-scanned every entry), so a deep queue
  under overload — exactly when expiries cluster — pays for what
  expired, not for what's waiting.
- **bounded depth sheds at push**: ``push`` on a full queue returns
  False (``shed_capacity``); the caller decides whether that's an error
  or load-shedding telemetry (ServeSession records a Result, the
  open-loop load generator counts it as overload).
- **fit-filtered pop**: the engine passes ``fit`` — "does this request
  fit the cache capacity left" — and the queue serves the best-priority
  request that fits, letting small requests overtake one that must wait
  for capacity (bounded head-of-line blocking, the same reason
  continuous batching exists at all).

Internals: one entry, three indexes — the priority heap, the deadline
heap (deadline'd entries only), and a FIFO deque (the aging guard).
Removal is LAZY: consuming an entry (popped or shed) clears its
``live`` flag and the other indexes skip dead entries when they
surface, so no index ever needs an O(n) purge.

The clock is injectable (monotonic seconds) so deadline and aging
behavior is testable without sleeping.
"""

from __future__ import annotations

import heapq
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from tpudl_torch.obs.spans import active_recorder

#: Request-lifecycle event/span category (admission -> prefill ->
#: decode chunks -> completion, stitched by ``report.py --request``).
CAT_SERVE_REQUEST = "serve_request"

#: Default starvation bound: the longest a low-priority entry can wait
#: behind a sustained high-priority stream before FIFO promotion.
DEFAULT_PROMOTE_AFTER_S = 30.0


@dataclass(order=True)
class _Entry:
    priority: int
    seq: int
    request: Any = field(compare=False)
    deadline: Optional[float] = field(compare=False)  # absolute clock time
    submitted_at: float = field(compare=False)
    #: False once consumed (popped or shed) — the lazy-deletion flag
    #: the priority/deadline/FIFO indexes check when an entry surfaces.
    live: bool = field(default=True, compare=False)


class AdmissionQueue:
    """Priority+FIFO bounded queue with pop-time deadline shedding and
    an aged-FIFO starvation guard (``promote_after_s``; None disables
    promotion)."""

    def __init__(
        self,
        capacity: int = 256,
        clock: Callable[[], float] = time.monotonic,
        promote_after_s: Optional[float] = DEFAULT_PROMOTE_AFTER_S,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if promote_after_s is not None and promote_after_s <= 0:
            raise ValueError(
                f"promote_after_s must be positive (None disables), "
                f"got {promote_after_s}"
            )
        self.capacity = capacity
        self.clock = clock
        self.promote_after_s = promote_after_s
        self._heap: List[_Entry] = []
        self._by_deadline: List[Tuple[float, int, _Entry]] = []
        self._fifo: deque = deque()
        self._live = 0
        self._seq = itertools.count()

    def __len__(self) -> int:
        return self._live

    @property
    def full(self) -> bool:
        return self._live >= self.capacity

    def _consume(self, entry: _Entry) -> _Entry:
        entry.live = False
        self._live -= 1
        return entry

    def push(
        self,
        request: Any,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> bool:
        """Enqueue; False when the queue is at capacity (the caller
        sheds). ``deadline_s`` is relative seconds from now — converted
        to an absolute clock deadline here, so time spent queued counts
        against it."""
        if self.full:
            return False
        now = self.clock()
        entry = _Entry(
            priority=priority,
            seq=next(self._seq),
            request=request,
            deadline=None if deadline_s is None else now + deadline_s,
            submitted_at=now,
        )
        heapq.heappush(self._heap, entry)
        self._fifo.append(entry)
        if entry.deadline is not None:
            heapq.heappush(
                self._by_deadline, (entry.deadline, entry.seq, entry)
            )
        self._live += 1
        self._maybe_compact()
        rec = active_recorder()
        if rec is not None:
            # Admission is where a request's trace begins: the queued
            # event anchors the queue-wait leg of the per-request
            # timeline (report.py --request).
            rec.event(
                "request_queued", CAT_SERVE_REQUEST,
                request_id=getattr(request, "request_id", None),
                req_priority=priority,
                deadline_s=deadline_s,
                depth=self._live,
            )
        return True

    def _maybe_compact(self) -> None:
        """Bound the lazy-deletion debris: a consumed entry stays in
        the indexes it was not consumed through until it surfaces, and
        an index whose head stays live (or, for the FIFO, a queue with
        promotion disabled) never surfaces them. Rebuild any index once
        its dead entries outnumber the live ones — amortized O(1) per
        push, and memory stays O(live) instead of O(all-time pushes)."""
        bound = 2 * self._live + 8
        if len(self._fifo) > bound:
            self._fifo = deque(e for e in self._fifo if e.live)
        if len(self._heap) > bound:
            self._heap = [e for e in self._heap if e.live]
            heapq.heapify(self._heap)
        if len(self._by_deadline) > bound:
            self._by_deadline = [
                t for t in self._by_deadline if t[2].live
            ]
            heapq.heapify(self._by_deadline)

    def _expire(self, now: float) -> List[_Entry]:
        """Shed every live entry whose deadline has passed — O(expired
        · log n) off the deadline heap, touching nothing still alive."""
        shed: List[_Entry] = []
        while self._by_deadline and self._by_deadline[0][0] < now:
            _, _, entry = heapq.heappop(self._by_deadline)
            if entry.live:
                shed.append(self._consume(entry))
        return shed

    def _aged_head(self, now: float) -> Optional[_Entry]:
        """The oldest live entry, iff it has waited past the promotion
        bound. Dead FIFO heads are discarded on the way EVEN when
        promotion is disabled — returning before the cleanup would let
        consumed entries (and their request payloads) accumulate in
        ``_fifo`` for the process lifetime."""
        while self._fifo and not self._fifo[0].live:
            self._fifo.popleft()
        if self.promote_after_s is None:
            return None
        if (
            self._fifo
            and now - self._fifo[0].submitted_at > self.promote_after_s
        ):
            return self._fifo[0]
        return None

    def pop(
        self,
        fit: Optional[Callable[[Any], bool]] = None,
    ) -> Tuple[Optional[_Entry], List[_Entry]]:
        """Best entry that is neither expired nor unfitting, plus every
        entry shed on the way (deadline passed before scheduling).

        "Best" is the aged FIFO head when one has waited past
        ``promote_after_s`` (starvation guard), else lowest
        (priority, seq). Entries that are alive but fail ``fit`` are
        left in place — they keep their priority and seq, so the
        FIFO-within-priority order is preserved across a skipped pop."""
        now = self.clock()
        shed = self._expire(now)
        aged = self._aged_head(now)
        if aged is not None and (fit is None or fit(aged.request)):
            return self._consume(aged), shed
        skipped: List[_Entry] = []
        picked: Optional[_Entry] = None
        while self._heap:
            entry = heapq.heappop(self._heap)
            if not entry.live:
                continue
            if fit is not None and not fit(entry.request):
                skipped.append(entry)
                continue
            picked = self._consume(entry)
            break
        for entry in skipped:
            heapq.heappush(self._heap, entry)
        return picked, shed

    def drain_all(self) -> List[_Entry]:
        """Hand back EVERY queued entry in scheduling order, emptying
        the queue — the engine's SLO-burn shed path (served-in-flight
        requests are untouched; only waiting work is returned)."""
        out = sorted(e for e in self._heap if e.live)
        for entry in out:
            self._consume(entry)
        self._heap = []
        self._by_deadline = []
        self._fifo.clear()
        return out

    def drain_expired(self) -> List[_Entry]:
        """Shed every expired entry without popping work (the engine's
        idle housekeeping so deadline misses surface even when no slot
        frees up)."""
        return self._expire(self.clock())
