"""Resumable data position: the port's counterpart of tpudl.ft.data,
the (epoch, offset) bookkeeping that makes a restarted run consume the
SAME batch schedule as an uninterrupted one.

``ResumableIterator`` wraps either a plain iterable (one epoch) or an
``epoch -> iterable`` factory (so shuffling can be epoch-seeded) and
counts what the CONSUMER actually pulled. Wrap it OUTSIDE any prefetch
stage: prefetch pulls ahead of the train step, and a position taken
inside the prefetcher would overcount by the staged depth. The wrapped
position is exact for fit(): fit pulls batch i, steps, then
checkpoints — ``state()`` at that moment says ``offset = i + 1`` =
"the next run starts at batch i + 1".

``seek(state)`` fast-forwards by draining (plain iterables) or by
jumping to the epoch and draining the offset (factories). Draining is
O(offset) batch constructions; for a converter-backed source prefer an
epoch factory whose iterable can skip cheaply. For a device feed
(tpudl_torch.data.prefetch.prefetch_to_device) the iterator wraps the
prefetcher, and a seek drains batches through it.

tpudl's ``resumable_request_log`` needs the request log
(``tpudl/obs/requestlog.py``), which is not ported (ROADMAP queue A
item 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Union

Source = Union[Iterable, Callable[[int], Iterable]]


class ResumableIterator:
    """Iterator with a checkpointable (epoch, offset) position."""

    def __init__(self, source: Source, epochs: Optional[int] = 1):
        """``source``: an iterable (single pass) or a callable
        ``epoch -> iterable``; with a callable, ``epochs=None`` means
        endless epoch rollover."""
        self._factory = source if callable(source) else None
        self._iterable = None if callable(source) else source
        self._epochs = epochs
        self._epoch = 0
        self._offset = 0
        self._it: Optional[Iterator] = None

    # -- position ------------------------------------------------------

    def state(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "offset": self._offset}

    def seek(self, state: Optional[Dict[str, int]]) -> "ResumableIterator":
        """Fast-forward to a checkpointed position. With an epoch
        factory the target epoch starts fresh and ``offset`` batches are
        drained; a plain iterable drains ``epoch * <unknowable> +
        offset`` — only offset, so plain iterables must be single-epoch
        (epoch > 0 raises)."""
        if not state:
            return self
        epoch = int(state.get("epoch", 0))
        offset = int(state.get("offset", 0))
        if self._factory is not None:
            self._epoch = epoch
            self._it = iter(self._factory(epoch))
        else:
            if epoch:
                raise ValueError(
                    "cannot seek a plain-iterable ResumableIterator to "
                    f"epoch {epoch}; pass an epoch->iterable factory"
                )
            self._ensure_iter()
        self._offset = 0
        for _ in range(offset):
            try:
                next(self._it)
            except StopIteration:
                raise ValueError(
                    f"seek past end of data: epoch {epoch} has fewer "
                    f"than {offset} batches"
                ) from None
            self._offset += 1
        return self

    # -- iteration -----------------------------------------------------

    def _ensure_iter(self) -> None:
        if self._it is None:
            if self._factory is not None:
                self._it = iter(self._factory(self._epoch))
            else:
                self._it = iter(self._iterable)

    def __iter__(self) -> "ResumableIterator":
        return self

    def __next__(self) -> Any:
        self._ensure_iter()
        while True:
            try:
                batch = next(self._it)
            except StopIteration:
                if self._factory is None:
                    raise
                next_epoch = self._epoch + 1
                if self._epochs is not None and next_epoch >= self._epochs:
                    raise
                self._epoch = next_epoch
                self._offset = 0
                self._it = iter(self._factory(next_epoch))
                continue
            self._offset += 1
            return batch
