"""KV-slot managers: the fixed-shape caches behind the engine.

The port's counterpart of tpudl.serve.cache: the dense ``SlotCache`` and
the paged ``PagedKVCache`` (below, with its int8 pages; the radix prefix
tree and migration wait for ROADMAP queue A item 3). The
engine's dense decode call runs on a fixed-slot cache (``[num_slots,
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

from tpudl_torch.models.paged import quantize_kv


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
        if device is None:
            device = next(leaf.device for leaf in _leaves(template)
                          if isinstance(leaf, torch.Tensor))
        # The write index: one 0-d device tensor every layer's "index"
        # entry holds, which each decode call advances in place
        # (tpudl_torch.models.llama), beside its host mirror.
        self._index = torch.zeros((), dtype=torch.int64, device=device)
        self.cache = _tree_map(
            lambda leaf: self._index if isinstance(leaf, int) else torch.zeros(
                leaf.shape, dtype=leaf.dtype, device=device),
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
            if isinstance(c, torch.Tensor) and c is not self._index:
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
        """The decode calls' next write slot, shared across rows: the host
        mirror of the cache's device ``index``, which every decode call
        advances in place; correct as long as every decode on
        ``self.cache`` is followed by one ``advance_write_index()``, which
        Engine._decode_step does. The horizon checks read this int, so
        nothing waits for the card."""
        return self._write_index

    def set_write_index(self, index: int) -> None:
        """Pin every layer's write index (after filling a fresh cache
        from batch-1 prefills, whose own indices ``insert`` discarded)."""
        self._index.fill_(int(index))
        self._write_index = int(index)

    def advance_write_index(self, steps: int = 1) -> None:
        """Advance the host mirror after a decode call advanced the
        device index."""
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
            if isinstance(leaf, torch.Tensor) and leaf is not self._index
        )

    def valid_counts(self) -> np.ndarray:
        """Per-slot count of valid (attendable) cache positions."""
        for leaf in _leaves(self.cache):
            if _is_valid_leaf(leaf):
                return leaf.sum(-1).cpu().numpy()
        raise AssertionError("unreachable: ctor checked a valid leaf")


# ---------------------------------------------------------------------------
# The paged cache
# ---------------------------------------------------------------------------

#: The ROADMAP item that ports the paged cache's other tiers.
_ITEM = "ROADMAP queue A item 3"


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to tpudl_torch yet ({_ITEM}: the radix "
        f"prefix cache and migration)")


class RadixPrefixTree:
    """tpudl's radix prefix tree (copy-on-write sharing of prompt pages):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported("RadixPrefixTree (prefix sharing)")


#: (values pool, scale pool, dense cache key) of each of k and v.
_POOLS = (("pages_k", "scale_k", "k"), ("pages_v", "scale_v", "v"))


def _attn_caches(tree: Any, path=()):
    """(path, attention dict) pairs of a decode cache: the dicts holding
    a layer's k/v (dense) or pages_k/pages_v (paged)."""
    if isinstance(tree, dict):
        if "k" in tree or "pages_k" in tree:
            yield path, tree
            return
        for key, value in tree.items():
            yield from _attn_caches(value, path + (key,))


def _at(tree: Any, path):
    for key in path:
        tree = tree[key]
    return tree


class PagedKVCache:
    """The paged successor to ``SlotCache`` (tpudl's, without the radix
    and migration tiers).

    KV lives in per-layer page pools ``[num_pages, page_size, Hkv, D]``
    (int8, with ``[num_pages, page_size, Hkv]`` f32 scale pools
    ``scale_k``/``scale_v`` beside them, when ``kv_dtype="int8"``: the
    prompt is quantized as it is seated, decode quantizes on the write
    and dequantizes in the gather, tpudl_torch.models.paged); a slot owns
    the pages its HOST-side page-table row maps. What the engine builds
    on:

    - **No shared write index**: each slot carries its own length, so
      the dense cache's horizon rollover does not exist here.
    - **Reservation-based admission**: ``seat`` reserves every page a
      request could need (``ceil((prompt window + max_new_tokens) /
      page_size)``) up front, so a seated request never strands
      mid-decode; ``fits_tokens`` is the admission predicate.
    - **Physical page 0 is the trash page**: free and idle slots' rows
      point at it, so their ride-along decode writes land where no live
      slot reads.

    ``template`` is the dense decode cache template (``init_cache(cfg,
    num_slots, device="meta")``); the pools take its layers, k/v dtypes
    and head shapes and are made zeroed on ``device``. The addressing
    (page table, per-slot start and length) is host numpy, shipped into
    each decode call (``dispatch_args``). Pool writes are in place."""

    #: Marks the paged engine path (Engine branches on this).
    paged = True

    def __init__(
        self,
        template: Any,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        prefix_share: bool = False,
        device: Optional[torch.device] = None,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None (store dtype) or 'int8', "
                             f"got {kv_dtype!r}")
        if prefix_share:
            _not_ported("prefix_share (the radix prefix cache)")
        valid = [leaf for leaf in _leaves(template) if _is_valid_leaf(leaf)]
        if not valid:
            raise ValueError(
                "cache template has no [num_slots, max_seq_len] bool "
                "validity leaf — not a tpudl_torch decode cache")
        self.num_slots = int(valid[0].shape[0])
        self.model_seq_len = int(valid[0].shape[1])
        self.page_size = int(page_size)
        self.quantized = kv_dtype == "int8"
        self.pages_per_slot = -(-self.model_seq_len // self.page_size)
        if num_pages is None:
            # Capacity parity with the dense cache (+1 trash page).
            num_pages = self.num_slots * self.pages_per_slot + 1
        if num_pages < self.pages_per_slot + 1:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one slot "
                f"(pages_per_slot={self.pages_per_slot} + trash page)")
        self.num_pages = int(num_pages)
        self.cache: dict = {}
        for path, attn in _attn_caches(template):
            node = self.cache
            for key in path[:-1]:
                node = node.setdefault(key, {})
            pool = {}
            for name, sname, kv in _POOLS:
                shape = (self.num_pages, self.page_size) + tuple(
                    attn[kv].shape[2:])
                dev = attn[kv].device if device is None else device
                pool[name] = torch.zeros(
                    shape, device=dev,
                    dtype=torch.int8 if self.quantized else attn[kv].dtype)
                if self.quantized:
                    pool[sname] = torch.zeros(shape[:-1], device=dev,
                                              dtype=torch.float32)
            node[path[-1]] = pool
        # Host-owned addressing: page 0 is never allocated.
        self._free: list = list(range(1, self.num_pages))
        self._reserved: dict = {}
        self.page_table = np.zeros((self.num_slots, self.pages_per_slot),
                                   np.int32)
        self.start = np.zeros((self.num_slots,), np.int32)
        self.lens = np.zeros((self.num_slots,), np.int32)

    # -- capacity ------------------------------------------------------

    @property
    def max_seq_len(self) -> int:
        """Logical positions addressable per slot — the admission bound,
        clamped to the model's sequence bound (a page_size that does not
        divide it rounds the page span up past positions the model does
        not have)."""
        return min(self.pages_per_slot * self.page_size, self.model_seq_len)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages seatable right now: the free pool (radix mode, not ported,
        would add its evictable pages)."""
        return len(self._free)

    def fits_tokens(self, tokens: int) -> bool:
        """Admission predicate: can a request that may write ``tokens``
        logical positions be seated right now? Reservation up front means
        yes here == never strands mid-decode."""
        return self.pages_needed(tokens) <= self.available_pages

    def fits_request(self, input_ids, tokens: int) -> bool:
        """Radix-mode admission; without the radix tree, ``fits_tokens``."""
        return self.fits_tokens(tokens)

    # -- seating / freeing ---------------------------------------------

    def seat(self, row_cache: Any, slot: int, pad: int, prompt_len: int,
             reserve_tokens: int) -> None:
        """Reserve pages for ``reserve_tokens`` logical positions and copy
        a batch-1 dense prefill row cache's prompt region (``[0,
        prompt_len)``) into the first of them, quantized with
        ``quantize_kv`` for int8 pools. ``pad`` is the row's
        left-pad count: logical positions below it stay masked, as dense
        validity masks them."""
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")
        if slot in self._reserved:
            raise ValueError(f"slot {slot} is already seated")
        if reserve_tokens > self.max_seq_len:
            raise ValueError(
                f"reserve_tokens {reserve_tokens} exceeds the logical "
                f"per-slot bound {self.max_seq_len}")
        n = self.pages_needed(reserve_tokens)
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n} pages, {len(self._free)} free "
                f"(admission should have checked fits_tokens)")
        pages = [self._free.pop() for _ in range(n)]
        self._reserved[slot] = pages
        self.page_table[slot, :] = 0
        self.page_table[slot, :n] = pages
        self.start[slot] = pad
        self.lens[slot] = prompt_len
        prompt_pages = self.pages_needed(prompt_len)
        span = prompt_pages * self.page_size
        for path, pool in _attn_caches(self.cache):
            row = _at(row_cache, path)
            ids = torch.as_tensor(pages[:prompt_pages],
                                  device=pool["pages_k"].device)
            for name, sname, kv in _POOLS:
                blocks = row[kv][0, :span]
                if blocks.shape[0] < span:
                    # page_size does not divide the model bound: the last
                    # prompt page runs past the dense row. Its tail sits
                    # past prompt_len, masked until decode writes it.
                    blocks = torch.cat([blocks, blocks.new_zeros(
                        (span - blocks.shape[0],) + tuple(blocks.shape[1:]))])
                blocks = blocks.reshape(prompt_pages, self.page_size,
                                        *blocks.shape[1:])
                if self.quantized:
                    q, sc = quantize_kv(blocks)
                    pool[name][ids] = q
                    pool[sname][ids] = sc
                else:
                    pool[name][ids] = blocks.to(pool[name].dtype)

    def free(self, slot: int) -> None:
        """Return the slot's pages to the pool and point its table row at
        the trash page (idle ride-along writes land there)."""
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")
        self._free.extend(self._reserved.pop(slot, ()))
        self.page_table[slot, :] = 0
        self.start[slot] = 0
        self.lens[slot] = 0

    def reset(self) -> None:
        """Free every slot (the pools keep their bytes, masked)."""
        for slot in list(self._reserved):
            self.free(slot)

    def seat_shared(self, *args, **kwargs):
        _not_ported("seat_shared (radix seating)")

    def gather_prefix_rows(self, *args, **kwargs):
        _not_ported("gather_prefix_rows (radix prefix rows)")

    def match_and_lease(self, *args, **kwargs):
        _not_ported("match_and_lease (radix prefix matching)")

    def export_request(self, *args, **kwargs):
        _not_ported("export_request (page-granular migration)")

    def import_request(self, *args, **kwargs):
        _not_ported("import_request (page-granular migration)")

    # -- the decode call's addressing ----------------------------------

    def dispatch_args(self):
        """The three small inputs each paged decode call takes:
        (page_table [B, P], start [B], lens [B]), host int32 copies."""
        return self.page_table.copy(), self.start.copy(), self.lens.copy()

    def advance(self, slots, steps: int = 1) -> None:
        """Advance the logical length of each ACTIVE slot after a decode
        call wrote its token(s) (idle slots stay at 0 on the trash
        page)."""
        for slot in slots:
            self.lens[slot] += steps

    def set_len(self, slot: int, length: int) -> None:
        """Pin one slot's logical length (per-slot bookkeeping only)."""
        self.lens[slot] = int(length)

    # -- accounting ----------------------------------------------------

    @property
    def nbytes(self) -> int:
        """Resident bytes: the page pools (an int8 pool's values and its
        scale pool) plus the host-side page table, start and lens (the
        number behind ``serve_cache_bytes``)."""
        device = sum(leaf.numel() * leaf.element_size()
                     for leaf in _leaves(self.cache)
                     if isinstance(leaf, torch.Tensor))
        return device + (self.page_table.nbytes + self.start.nbytes
                         + self.lens.nbytes)
