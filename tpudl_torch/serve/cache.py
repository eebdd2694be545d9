"""KV-slot manager: the fixed-shape cache behind the engine.

The port's counterpart of tpudl.serve.cache's dense ``SlotCache`` (the
paged, int8 and radix caches and migration wait for later slices). The
engine's decode call runs on a fixed-slot cache (``[num_slots,
max_seq_len, ...]`` per layer, the layout
tpudl_torch.models.llama.init_cache builds). Continuous batching never
reshapes it — requests come and go by mutating WHICH rows mean
something:

- ``insert(row_cache, slot)`` copies a batch-1 prefill's cache row into
  an occupied batch (k/v/valid rows replaced wholesale);
- ``free(slot)`` zeroes the slot's validity row (its k/v bytes remain
  but are unreachable — attention masks by slot order AND validity);
- ``reset()`` returns the whole cache to zeros, restoring the full
  write horizon (the engine's rollover).

Unlike the JAX package, every mutation is IN PLACE on the cache tensors
(no cache-sized copy per insert). Insertion into an occupied cache is
sound for the same reason as there: positions only drive RoPE phases,
masking is by slot order and validity, and every per-row op is
batch-independent.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zip_leaves(tree: Any, other: Any) -> Iterator[tuple]:
    """(leaf, matching leaf of ``other``) pairs, matched by key path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _zip_leaves(v, other[k])
    else:
        yield tree, other


def _is_valid_leaf(leaf) -> bool:
    """The per-slot validity buffer: [num_slots, max_seq_len] bool."""
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.dim() == 2
        and leaf.dtype == torch.bool
    )


class SlotCache:
    """Owns the engine's cache dict and the slot bookkeeping on it.

    ``template`` is a cache dict with leading dim ``num_slots`` (e.g.
    ``init_cache(cfg, num_slots, device="meta")``); the concrete cache
    starts zeroed on ``device`` (default: the template's) — all-invalid,
    which decode tolerates (an all-masked row softmaxes to uniform
    weights over finite mask values; its output is discarded)."""

    #: Marks the dense engine path.
    paged = False

    def __init__(self, template: Any, device: Optional[torch.device] = None):
        self.cache = _tree_map(
            lambda leaf: 0 if isinstance(leaf, int) else torch.zeros(
                leaf.shape, dtype=leaf.dtype,
                device=leaf.device if device is None else device,
            ),
            template,
        )
        valid = [leaf for leaf in _leaves(self.cache) if _is_valid_leaf(leaf)]
        if not valid:
            raise ValueError(
                "cache template has no [num_slots, max_seq_len] bool "
                "validity leaf — not a tpudl_torch decode cache (expected "
                "the dict prefill_fn returns)"
            )
        self.num_slots = int(valid[0].shape[0])
        self.max_seq_len = int(valid[0].shape[1])
        self._write_index = 0

    # -- slot mutation -------------------------------------------------

    def _check_slot(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")

    def insert(self, row_cache: Any, slot: int) -> None:
        """Copy a batch-1 cache row into ``slot``. The shared write index
        keeps the BATCH cache's value (the row's index is its own prompt
        length and must not rewind the live batch)."""
        self._check_slot(slot)
        for c, r in _zip_leaves(self.cache, row_cache):
            if isinstance(c, torch.Tensor):
                c[slot].copy_(r[0])

    def free(self, slot: int) -> None:
        self._check_slot(slot)
        for leaf in _leaves(self.cache):
            if _is_valid_leaf(leaf):
                leaf[slot] = False

    def reset(self) -> None:
        """All slots empty, write index 0: the full horizon is back."""
        for leaf in _leaves(self.cache):
            if isinstance(leaf, torch.Tensor):
                leaf.zero_()
        self.set_write_index(0)

    # -- the shared write index ----------------------------------------

    @property
    def write_index(self) -> int:
        """The decode calls' next write slot, shared across rows. Mirrors
        the cache's own ``index`` entries, which every decode call
        advances; correct as long as every decode on ``self.cache`` is
        followed by one ``advance_write_index()``, which
        Engine._decode_step does."""
        return self._write_index

    def set_write_index(self, index: int) -> None:
        """Pin every layer's write index (after filling a fresh cache
        from batch-1 prefills, whose own indices ``insert`` discarded)."""
        self.cache = _tree_map(
            lambda leaf: int(index) if isinstance(leaf, int) else leaf,
            self.cache,
        )
        self._write_index = int(index)

    def advance_write_index(self, steps: int = 1) -> None:
        self._write_index += steps

    @property
    def remaining_horizon(self) -> int:
        """Decode steps left before the cache is full."""
        return self.max_seq_len - self.write_index

    # -- accounting ----------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Resident bytes of the cache tensors (the number behind the
        ``serve_cache_bytes`` gauge)."""
        return sum(
            leaf.numel() * leaf.element_size()
            for leaf in _leaves(self.cache)
            if isinstance(leaf, torch.Tensor)
        )

    def valid_counts(self) -> np.ndarray:
        """Per-slot count of valid (attendable) cache positions."""
        for leaf in _leaves(self.cache):
            if _is_valid_leaf(leaf):
                return leaf.sum(-1).cpu().numpy()
        raise AssertionError("unreachable: ctor checked a valid leaf")
