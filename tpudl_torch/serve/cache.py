"""KV-slot managers: the fixed-shape caches behind the engine.

The port's counterpart of tpudl.serve.cache: the dense ``SlotCache`` and
the paged ``PagedKVCache`` (below, with its int8 pages, the radix
prefix tree's copy-on-write page sharing and page-granular migration:
``export_request`` / ``import_request`` over the ``pack_migration`` wire
format, byte for byte tpudl's). The engine's dense decode call runs on a fixed-slot
cache (``[num_slots, max_seq_len, ...]`` per layer, the layout
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

import json
import struct
import threading
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from tpudl_torch.ft.store import dtype_name, torch_dtype
from tpudl_torch.models.paged import flat_page_row_index, quantize_kv


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

def _is_attn_cache(node) -> bool:
    """A per-layer dense decode cache dict: the four leaves
    LlamaAttention's decode branch keeps (init_cache's layout)."""
    return isinstance(node, dict) and set(node) >= {"k", "v", "valid",
                                                    "index"}


def _map_attn_caches(tree, fn):
    """The cache tree with every per-layer attention cache dict replaced
    by ``fn(dict)`` (the dense template -> the dense row template)."""
    if _is_attn_cache(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_attn_caches(v, fn) for k, v in tree.items()}
    return tree


def _zip_attn_caches(a, b, fn):
    """Walk two structurally parallel cache trees; replace each per-layer
    pair with ``fn(a_dict, b_dict)`` (a page pool and the matching layer
    of a dense row cache, or of the dense row template)."""
    if isinstance(a, dict) and ("pages_k" in a or _is_attn_cache(a)):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _zip_attn_caches(v, b[k], fn) for k, v in a.items()}
    return a


# ---------------------------------------------------------------------------
# Radix prefix tree (copy-on-write page sharing)
# ---------------------------------------------------------------------------


def block_hash(block: Tuple[int, ...]) -> int:
    """Child-index key for one page-sized token block. Module-level so
    tests can monkeypatch it into collisions: the tree NEVER trusts the
    hash alone, every lookup compares the full token tuple."""
    return hash(block)


class _RadixNode:
    """One compressed radix-tree edge: a run of page-sized token blocks
    and the physical pages holding their KV, parallel lists. A lease (one
    seated slot mapping through this node) increments ``refcount`` on the
    node AND every ancestor, so ``refcount == 0`` implies the whole
    subtree is lease-free (the eviction-safety invariant)."""

    __slots__ = ("blocks", "pages", "children", "parent", "refcount",
                 "stamp")

    def __init__(self, blocks, pages, parent):
        self.blocks: List[Tuple[int, ...]] = blocks
        self.pages: List[int] = pages
        #: hash(first block) -> [nodes]. A list per hash: collisions
        #: resolve by comparing the stored block tuples.
        self.children: Dict[int, List["_RadixNode"]] = {}
        self.parent: Optional["_RadixNode"] = parent
        self.refcount = 0
        self.stamp = 0  # LRU recency (tree._clock at last touch)


class RadixPrefixTree:
    """Prefix index over page-granular token blocks -> physical KV pages
    (tpudl's, semantics unchanged). ``match_and_lease`` walks a prompt's
    full token blocks down the tree, SPLITTING a partially matched
    compressed edge at the divergence (the copy-on-write split: the
    shared half keeps the shared pages, both continuations hang under
    it), pins every matched node with a refcount lease and returns the
    matched pages, which the seat maps into the new slot's page table
    for free. ``insert_suffix`` registers freshly prefilled full blocks
    so later requests hit them. Releasing a lease does NOT free the
    pages: refcount-0 nodes stay cached as the EVICTABLE pool, reclaimed
    leaf-first in LRU order under page pressure (``evict``). Every public
    method takes the internal lock (tpudl's router probes ``match_len``
    from its own thread). Scans are O(tree)."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = _RadixNode([], [], None)
        self._lock = threading.RLock()
        self._clock = 0
        #: Pages in refcount-0 nodes: reclaimable without touching any
        #: live slot (kept up to date by lease and release).
        self.evictable_pages = 0
        #: Pages the tree holds in all (leased + evictable).
        self.cached_pages = 0
        self.num_splits = 0
        self.num_evictions = 0

    # -- block helpers --------------------------------------------------

    def blocks_of(self, tokens) -> List[Tuple[int, ...]]:
        """The FULL page-sized token blocks of a prompt (the sharable
        granularity; a trailing partial block is always private)."""
        ps = self.page_size
        n = len(tokens) // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n)]

    def _child(self, node: _RadixNode, block) -> Optional[_RadixNode]:
        for cand in node.children.get(block_hash(block), ()):
            # Full token-block compare: a hash collision must select by
            # VALUE or two different prompts would share wrong KV.
            if cand.blocks[0] == block:
                return cand
        return None

    def _attach(self, parent: _RadixNode, node: _RadixNode) -> None:
        node.parent = parent
        parent.children.setdefault(block_hash(node.blocks[0]), []).append(
            node)

    def _detach(self, node: _RadixNode) -> None:
        key = block_hash(node.blocks[0])
        siblings = node.parent.children.get(key, [])
        siblings.remove(node)
        if not siblings:
            del node.parent.children[key]

    # -- queries --------------------------------------------------------

    def match_len(self, tokens) -> int:
        """Longest cached prefix of ``tokens`` in TOKENS (page-granular,
        read-only)."""
        return self.match_info(tokens)[0]

    def match_info(self, tokens) -> Tuple[int, int]:
        """``(matched_tokens, matched_evictable_pages)``: the second
        counts matched pages now in the EVICTABLE pool (refcount 0).
        Admission needs it: seating pins those pages, so they cannot also
        satisfy the request's remaining allocation."""
        with self._lock:
            blocks = self.blocks_of(tokens)
            node, i = self.root, 0
            evictable = 0
            while i < len(blocks):
                child = self._child(node, blocks[i])
                if child is None:
                    break
                j = 0
                while (j < len(child.blocks) and i + j < len(blocks)
                       and child.blocks[j] == blocks[i + j]):
                    j += 1
                if j and child.refcount == 0:
                    # A partial match splits at lease time; the matched
                    # half inherits this refcount, so counting its j
                    # pages is exact.
                    evictable += j
                i += j
                if j < len(child.blocks):
                    break
                node = child
            return i * self.page_size, evictable

    # -- lease lifecycle ------------------------------------------------
    #
    # A lease is represented by its DEEPEST node; acquire and release walk
    # the ancestor path. A copy-on-write split copies the node's refcount
    # onto the new upper half (every lease through the node also covers
    # its prefix), and a later release's walk decrements both halves once.

    def _acquire_path(self, node: _RadixNode) -> None:
        self._clock += 1
        while node is not None and node is not self.root:
            if node.refcount == 0:
                self.evictable_pages -= len(node.pages)
            node.refcount += 1
            node.stamp = self._clock
            node = node.parent

    def release(self, lease: Optional[_RadixNode]) -> None:
        """Drop one seat's pin (``lease`` = the deepest node
        ``match_and_lease`` / ``insert_suffix`` handed out). Refcount-0
        nodes stay CACHED: their pages join the evictable pool, freed only
        by LRU eviction under pressure."""
        if lease is None:
            return
        with self._lock:
            node = lease
            while node is not None and node is not self.root:
                node.refcount -= 1
                assert node.refcount >= 0, "radix lease released twice"
                if node.refcount == 0:
                    self.evictable_pages += len(node.pages)
                node = node.parent

    def match_and_lease(self, tokens):
        """Walk ``tokens``'s full blocks, splitting a partially matched
        edge at the divergence, and LEASE the matched path. Returns
        ``(matched_pages, deepest_node_or_None)``; the caller owns the
        lease and must ``release`` it exactly once
        (``PagedKVCache.free`` does, per seated slot)."""
        with self._lock:
            blocks = self.blocks_of(tokens)
            node, i = self.root, 0
            pages: List[int] = []
            while i < len(blocks):
                child = self._child(node, blocks[i])
                if child is None:
                    break
                j = 0
                while (j < len(child.blocks) and i + j < len(blocks)
                       and child.blocks[j] == blocks[i + j]):
                    j += 1
                if j == 0:
                    break
                if j < len(child.blocks):
                    # Divergence (or prompt end) inside the compressed
                    # edge: split so the matched half is its own node;
                    # leases and eviction then stay whole-node.
                    child = self._split_at(child, j)
                pages.extend(child.pages)
                i += j
                node = child
            if node is self.root:
                return pages, None
            self._acquire_path(node)
            return pages, node

    def _split_at(self, node: _RadixNode, j: int) -> _RadixNode:
        """Split a compressed edge at block ``j``: blocks[:j] become a new
        (shared) parent keeping those pages, blocks[j:] stay on ``node``,
        hung underneath. Refcount and stamp copy to the new parent, so the
        path invariant (ancestor refcount >= descendant) holds."""
        upper = _RadixNode(node.blocks[:j], node.pages[:j], None)
        upper.refcount = node.refcount
        upper.stamp = node.stamp
        parent = node.parent
        self._detach(node)
        self._attach(parent, upper)
        node.blocks = node.blocks[j:]
        node.pages = node.pages[j:]
        self._attach(upper, node)
        self.num_splits += 1
        return upper

    def insert_suffix(self, parent, blocks, pages):
        """Register freshly prefilled full blocks under ``parent`` (the
        deepest matched node, or None for the root): the tree takes
        OWNERSHIP of those pages (they return to the pool only by
        eviction). The new node is born refcount 1: it extends the
        seating slot's lease, whose ancestors ``match_and_lease`` already
        pinned, and becomes the lease's deepest node. Returns None when
        there is nothing to insert (the caller keeps the match lease)."""
        if not blocks:
            return None
        assert len(blocks) == len(pages)
        with self._lock:
            node = _RadixNode(list(blocks), list(pages), None)
            self._attach(parent if parent is not None else self.root, node)
            self.cached_pages += len(pages)
            node.refcount = 1  # pinned by the seating slot from birth
            self._clock += 1
            node.stamp = self._clock
            return node

    # -- eviction -------------------------------------------------------

    def _evictable_leaves(self) -> List[_RadixNode]:
        out: List[_RadixNode] = []

        def walk(node: _RadixNode) -> None:
            for cands in node.children.values():
                for child in cands:
                    walk(child)
            if (node is not self.root and node.refcount == 0
                    and not node.children):
                out.append(node)

        walk(self.root)
        return out

    def evict(self, need_pages: int) -> List[int]:
        """Reclaim up to ``need_pages`` pages by evicting refcount-0 LEAF
        nodes oldest stamp first (an interior node becomes a leaf only
        once its subtree is gone, and refcount 0 means no lease anywhere
        below). Returns the freed page ids."""
        freed: List[int] = []
        with self._lock:
            while len(freed) < need_pages:
                leaves = self._evictable_leaves()
                if not leaves:
                    break
                victim = min(leaves, key=lambda n: n.stamp)
                self._detach(victim)
                freed.extend(victim.pages)
                self.cached_pages -= len(victim.pages)
                self.evictable_pages -= len(victim.pages)
                self.num_evictions += 1
        return freed

    def stats(self) -> dict:
        with self._lock:
            n_nodes = 0
            stack = [self.root]
            while stack:
                node = stack.pop()
                n_nodes += 1
                for cands in node.children.values():
                    stack.extend(cands)
            return {
                "nodes": n_nodes - 1,  # excluding the root
                "cached_pages": self.cached_pages,
                "evictable_pages": self.evictable_pages,
                "splits": self.num_splits,
                "evictions": self.num_evictions,
            }


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


class PagedKVCache:
    """The paged successor to ``SlotCache`` (tpudl's).

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
    each decode call (``dispatch_args``). Pool writes are in place.

    ``prefix_share=True`` adds the RADIX tier (``RadixPrefixTree``):
    seating goes LEFT-ALIGNED through ``seat_shared`` (token ``i`` at
    logical position ``i``, so identical token prefixes are
    page-identical), matched full pages map copy-on-write for free, freed
    prompts stay CACHED (evictable at refcount 0, reclaimed LRU leaf
    first under pressure), and ``gather_prefix_rows`` turns a cached
    prefix back into dense rows for the chunked suffix prefill.
    ``capture`` (the port's; on the card) makes that gather one CUDA
    graph for every match length: its first call runs eagerly, its
    second captures, every later call replays.

    ``export_request`` / ``import_request`` move one seated request's
    rows between caches as a crc32-guarded payload (``pack_migration``):
    the rows in stored dtype (int8 pages as int8, with their scale rows),
    gathered out of the pools and scattered into fresh pages of the
    target, in place."""

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
        capture: bool = False,
    ):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype must be None (store dtype) or 'int8', "
                             f"got {kv_dtype!r}")
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
        # Prefix sharing (radix mode): seating is LEFT-ALIGNED (token i of
        # every prompt at logical position i, start 0), so identical token
        # prefixes land on identical page-aligned content. The dense row
        # template (batch 1, meta) shapes gather_prefix_rows' output.
        self.prefix_share = bool(prefix_share)
        self.radix: Optional[RadixPrefixTree] = None
        self._leases: dict = {}
        self._row_template = None
        self.capture = bool(capture)
        self._gather_calls = 0
        self._gather_graph = None
        self._gather_inputs = None
        self._gather_out = None
        if self.prefix_share:
            self.radix = RadixPrefixTree(self.page_size)
            self._row_template = _map_attn_caches(template, lambda attn: {
                key: (torch.empty((1,) + tuple(leaf.shape[1:]),
                                  dtype=leaf.dtype, device="meta")
                      if isinstance(leaf, torch.Tensor) else leaf)
                for key, leaf in attn.items()})

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
        """Pages seatable right now: the free pool plus (radix mode) the
        refcount-0 tree pages, which eviction reclaims without touching
        any live slot."""
        extra = self.radix.evictable_pages if self.radix is not None else 0
        return len(self._free) + extra

    def fits_tokens(self, tokens: int) -> bool:
        """Admission predicate: can a request that may write ``tokens``
        logical positions be seated right now? Reservation up front means
        yes here == never strands mid-decode."""
        return self.pages_needed(tokens) <= self.available_pages

    def fits_request(self, input_ids, tokens: int) -> bool:
        """Radix-mode admission: matched prefix pages map for free, so only
        the unshared remainder counts against the pool. Matched pages that
        are now refcount 0 get PINNED by the seat, so they are excluded
        from the reclaimable side (counting them both as free to map and
        as evictable would admit a request ``seat_shared`` cannot place).
        Without the radix tree, ``fits_tokens``."""
        if self.radix is None:
            return self.fits_tokens(tokens)
        matched, matched_evictable = self.radix.match_info(input_ids)
        need = self.pages_needed(tokens) - matched // self.page_size
        avail = len(self._free) + (self.radix.evictable_pages
                                   - matched_evictable)
        return need <= avail

    def prefix_match_len(self, input_ids) -> int:
        """Cached-prefix length (tokens) of a prompt, 0 when prefix
        sharing is off. Read-only."""
        if self.radix is None:
            return 0
        return self.radix.match_len(input_ids)

    # -- seating / freeing ---------------------------------------------

    def seat(self, row_cache: Any, slot: int, pad: int, prompt_len: int,
             reserve_tokens: int) -> None:
        """Reserve pages for ``reserve_tokens`` logical positions and copy
        a batch-1 dense prefill row cache's prompt region (``[0,
        prompt_len)``) into the first of them, quantized with
        ``quantize_kv`` for int8 pools. ``pad`` is the row's
        left-pad count: logical positions below it stay masked, as dense
        validity masks them."""
        if self.prefix_share:
            raise ValueError(
                "prefix-share caches seat left-aligned via seat_shared "
                "(pad-aligned seat would break the radix tree's canonical "
                "token -> logical position mapping)")
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
        self._scatter_rows(row_cache, pages[:self.pages_needed(prompt_len)],
                           0)

    # -- prefix-sharing (radix) seating ---------------------------------

    def match_and_lease(self, input_ids):
        """Radix walk + lease for one prompt (the engine's seat path): the
        matched pages map into the slot's table for free; the lease pins
        them until ``free`` / ``release_lease``. See
        ``RadixPrefixTree.match_and_lease``."""
        if self.radix is None:
            raise ValueError("match_and_lease requires prefix_share=True")
        return self.radix.match_and_lease(input_ids)

    def release_lease(self, lease) -> None:
        """Failure-path unpin (a lease whose seat never completed)."""
        if lease is not None:
            self.radix.release(lease)

    def _alloc_pages(self, n: int) -> list:
        """Pop ``n`` pages from the free pool, evicting LRU refcount-0
        radix nodes when the pool alone is short (the path
        ``available_pages`` promised)."""
        if n > len(self._free) and self.radix is not None:
            self._free.extend(self.radix.evict(n - len(self._free)))
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n} pages, {len(self._free)} free "
                f"(admission should have checked fits_tokens)")
        return [self._free.pop() for _ in range(n)]

    def seat_shared(self, row_cache: Any, slot: int, input_ids,
                    reserve_tokens: int, lease=None,
                    row_offset: int = 0) -> None:
        """LEFT-ALIGNED radix seating: token ``i`` of the prompt lives at
        logical position ``i`` (start 0), so identical prefixes are
        page-identical across requests. ``lease`` is the
        ``match_and_lease`` result whose pages map into the table for
        free; only the UNSHARED remainder allocates (evicting LRU cached
        pages under pressure), and only the unshared pages of
        ``row_cache`` are scattered: shared pages are never rewritten
        (copy-on-write: decode writes land at ``lens >= ids_len``, in
        private pages). ``row_offset`` is where the prompt's first token
        sits in the dense row (its left-pad count for a full-prefill row;
        0 for a chunk-prefill row). The prompt's freshly written FULL
        pages go into the tree so later requests hit them."""
        ids = np.asarray(input_ids, np.int32)
        ids_len = int(ids.shape[0])
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")
        if slot in self._reserved or slot in self._leases:
            raise ValueError(f"slot {slot} is already seated")
        matched_pages, deepest = lease if lease is not None else ([], None)
        m = len(matched_pages)
        try:
            if reserve_tokens > self.max_seq_len:
                raise ValueError(
                    f"reserve_tokens {reserve_tokens} exceeds the logical "
                    f"per-slot bound {self.max_seq_len}")
            assert m * self.page_size <= ids_len, (
                "lease longer than the prompt: matched against the wrong "
                "request")
            new_pages = self._alloc_pages(self.pages_needed(reserve_tokens)
                                          - m)
        except BaseException:
            self.release_lease(deepest)
            raise
        prompt_pages = self.pages_needed(ids_len)
        full = ids_len // self.page_size
        self.page_table[slot, :] = 0
        self.page_table[slot, :m] = matched_pages
        self.page_table[slot, m:m + len(new_pages)] = new_pages
        self.start[slot] = 0
        self.lens[slot] = ids_len
        # Scatter ONLY the unshared prompt pages [m, prompt_pages); the
        # matched pages keep their (identical) bytes untouched.
        if prompt_pages > m:
            self._scatter_rows(row_cache, new_pages[:prompt_pages - m],
                               row_offset + m * self.page_size)
        # The prompt's full pages enter the tree (tree-owned: back to the
        # pool only by eviction); the partial tail and the decode reserve
        # stay private to the slot.
        node = self.radix.insert_suffix(
            deepest, self.radix.blocks_of(ids)[m:full],
            new_pages[:full - m])
        final = node if node is not None else deepest
        if final is not None:
            self._leases[slot] = final
        self._reserved[slot] = new_pages[full - m:]

    def _scatter_rows(self, row_cache: Any, pages: list, first_row: int):
        """Write dense rows ``[first_row, first_row + len(pages) x
        page_size)`` of a batch-1 row cache into ``pages`` of every layer's
        pools, quantized with ``quantize_kv`` for int8 pools. Rows past the
        dense row (a page_size that does not divide the model bound) are
        zeros: they sit past the prompt, masked until decode writes them."""
        n, ps = len(pages), self.page_size

        def one(pool: dict, row: dict) -> dict:
            ids = torch.as_tensor(pages, device=pool["pages_k"].device)
            for name, sname, kv in _POOLS:
                rows = row[kv][0, first_row:first_row + n * ps]
                if rows.shape[0] < n * ps:
                    rows = torch.cat([rows, rows.new_zeros(
                        (n * ps - rows.shape[0],) + tuple(rows.shape[1:]))])
                blocks = rows.reshape(n, ps, *rows.shape[1:])
                if self.quantized:
                    q, sc = quantize_kv(blocks)
                    pool[name][ids] = q
                    pool[sname][ids] = sc
                else:
                    pool[name][ids] = blocks.to(pool[name].dtype)
            return pool

        _zip_attn_caches(self.cache, row_cache, one)

    def gather_prefix_rows(self, matched_pages, matched_tokens: int):
        """Materialize a leased prefix into a batch-1 DENSE row cache (k/v
        rows of every logical position of the slot's span, validity set
        below ``matched_tokens``, one device write index at
        ``matched_tokens`` shared by every layer): the input the chunked
        suffix prefill resumes from, and writes in place. One program for
        every match length (the page ids ride in padded with the trash
        page); with ``capture`` one CUDA graph, whose output buffers the
        next call rewrites."""
        if self._row_template is None:
            raise ValueError(
                "gather_prefix_rows requires prefix_share=True (needs the "
                "dense row template)")
        page_ids = np.zeros((self.pages_per_slot,), np.int64)
        page_ids[:len(matched_pages)] = matched_pages
        values = {"page_ids": page_ids, "m_tok": np.int64(matched_tokens)}
        device = next(_leaves(self.cache)).device
        self._gather_calls += 1
        if not self.capture or self._gather_calls == 1:
            return self._gather_body({k: torch.as_tensor(v, device=device)
                                      for k, v in values.items()})
        from tpudl_torch.graphs import Graph, StaticInputs

        if self._gather_graph is None:
            self._gather_inputs = StaticInputs(values, device)
            self._gather_graph = Graph()
            self._gather_out = self._gather_graph.capture(
                self._gather_body, self._gather_inputs.bufs)
        else:
            self._gather_inputs.fill(values)
        self._gather_graph.replay()
        return self._gather_out

    @property
    def gather_capture_s(self) -> Optional[float]:
        """Wall seconds of the gather's capture (None before it)."""
        return None if self._gather_graph is None else \
            self._gather_graph.capture_s

    def _gather_body(self, inputs: dict):
        """The gather's device work (no host reads): tpudl's
        ``_make_gather_rows_fn``."""
        ps = self.page_size
        span = self.pages_per_slot * ps
        flat_idx = flat_page_row_index(inputs["page_ids"], ps)
        m_tok = inputs["m_tok"]
        index = m_tok.clone()

        def one(pool: dict, tmpl: dict) -> dict:
            seq = int(tmpl["k"].shape[1])
            out = {}
            for name, sname, kv in _POOLS:
                rows = pool[name].view(-1, *pool[name].shape[2:])[flat_idx]
                if self.quantized:
                    sc = pool[sname].view(-1, pool[sname].shape[2])
                    rows = rows.float() * sc[flat_idx][..., None]
                if span >= seq:
                    rows = rows[:seq]
                else:
                    rows = torch.cat([rows, rows.new_zeros(
                        (seq - span,) + tuple(rows.shape[1:]))])
                out[kv] = rows[None].to(tmpl[kv].dtype)
            out["valid"] = (torch.arange(seq, device=m_tok.device)
                            < m_tok)[None, :]
            out["index"] = index
            return out

        return _zip_attn_caches(self.cache, self._row_template, one)

    def free(self, slot: int) -> None:
        """Return the slot's PRIVATE pages to the pool, release its radix
        lease (shared pages stay cached in the tree, evictable once their
        refcount drops to 0), and point its table row at the trash page
        (idle ride-along writes land there)."""
        if not 0 <= slot < self.num_slots:
            raise IndexError(f"slot {slot} out of range [0, {self.num_slots})")
        lease = self._leases.pop(slot, None)
        if lease is not None and self.radix is not None:
            self.radix.release(lease)
        self._free.extend(self._reserved.pop(slot, ()))
        self.page_table[slot, :] = 0
        self.start[slot] = 0
        self.lens[slot] = 0

    def reset(self) -> None:
        """Free every slot (the pools keep their bytes, masked). Radix
        mode: the prefix cache SURVIVES a reset; ``drop_prefix_cache``
        clears it too."""
        for slot in list(set(self._reserved) | set(self._leases)):
            self.free(slot)

    def drop_prefix_cache(self) -> None:
        """Evict every lease-free radix page back to the pool (after
        ``reset``, the whole tree)."""
        if self.radix is not None:
            self._free.extend(self.radix.evict(self.radix.evictable_pages))

    # -- page-granular migration ---------------------------------------

    def export_request(self, slot: int, meta: dict, skip_tokens: int = 0,
                       extra_leaves=()) -> bytes:
        """Serialize one seated request's KV state into one crc32-guarded
        payload (tpudl's): its logical rows ``[skip_tokens, lens)``
        gathered out of the page pools in STORED dtype (int8 pages ship
        as int8 with their scale rows, so a quantized request resumes bit
        for bit), plus the addressing (``lens`` / ``start`` / alignment)
        the target rebuilds its page-table row from. ``meta`` is the
        engine's request and sampling state riding along.

        ``skip_tokens`` is the reference-first prefix: the caller probed
        (and LEASED) that many tokens in the TARGET's radix tree, so they
        ship as the prompt ids already in ``meta`` instead of rows; a
        target whose tree no longer holds them refuses the import
        (``MigrationCompatError``). ``extra_leaves`` ride along under
        their own paths (the draft's nested payload), crc-covered.

        Non-destructive: the caller frees the slot once the payload
        exists."""
        if slot not in self._reserved and slot not in self._leases:
            raise ValueError(f"slot {slot} is not seated")
        lens = int(self.lens[slot])
        start = int(self.start[slot])
        left_aligned = start == 0
        skip = int(skip_tokens)
        if not 0 <= skip <= lens:
            raise ValueError(f"skip_tokens {skip} outside [0, {lens}]")
        if skip and not left_aligned:
            raise ValueError(
                "reference-prefix export requires a left-aligned slot "
                "(pad-aligned rows cannot match the radix tree's canonical "
                "token->position mapping)")
        ps = self.page_size
        pos = np.arange(skip, lens, dtype=np.int64)
        flat = self.page_table[slot, pos // ps].astype(np.int64) * ps + pos % ps
        leaves = _pool_leaves(self.cache)
        idx = torch.as_tensor(flat, device=leaves[0][1].device)
        # Every gather is queued before the first readback waits.
        rows = [(path, pool.view(-1, *pool.shape[2:])[idx])
                for path, pool in leaves]
        rows = [(path, r.cpu()) for path, r in rows]
        rows.extend(extra_leaves)
        payload_meta = dict(meta)
        payload_meta.update(
            kind="tpudl-kv-migration",
            lens=lens,
            start=start,
            skip_tokens=skip,
            left_aligned=left_aligned,
            page_size=self.page_size,
            quantized=self.quantized,
        )
        return pack_migration(payload_meta, rows)

    def import_request(self, payload, slot: int, lease=None) -> dict:
        """Seat a migrated request's KV into ``slot`` from an
        ``export_request`` payload (bytes, or its parsed meta): verify the
        crc, allocate the full reservation, scatter the shipped rows into
        fresh pages IN PLACE and rebuild the page-table row — no prefill.
        ``lease`` is a pre-pinned ``match_and_lease`` result (the prefix
        the export skipped); without one, a prefix-share cache matches
        here. The lease is CONSUMED: released on every failure path,
        installed into the slot's bookkeeping on success.

        Raises ``MigrationCorruptError`` on a payload that fails
        validation and ``MigrationCompatError`` on a valid payload this
        cache cannot seat (quantization or geometry mismatch, a
        reservation past the per-slot bound, a reference prefix the tree
        no longer holds). Returns the payload's meta dict."""
        meta = payload if isinstance(payload, dict) else parse_migration(
            payload)
        matched_pages: list = []
        deepest = None
        if lease is not None:
            matched_pages, deepest = lease
        try:
            if meta.get("kind") != "tpudl-kv-migration":
                raise MigrationCorruptError(
                    "payload is not a tpudl KV migration")
            if bool(meta["quantized"]) != self.quantized:
                raise MigrationCompatError(
                    f"payload kv quantization ({meta['quantized']}) does not "
                    f"match this cache ({self.quantized})")
            if not 0 <= slot < self.num_slots:
                raise IndexError(
                    f"slot {slot} out of range [0, {self.num_slots})")
            if slot in self._reserved or slot in self._leases:
                raise ValueError(f"slot {slot} is already seated")
            if lease is not None and self.radix is None:
                raise ValueError("import lease given but prefix_share is off")
        except BaseException:
            self.release_lease(deepest)
            raise
        lens = int(meta["lens"])
        start = int(meta["start"])
        skip = int(meta["skip_tokens"])
        reserve = max(int(meta["reserve_tokens"]), lens)
        ids = np.asarray(meta["request"]["input_ids"], np.int32)
        if lease is not None and not meta["left_aligned"]:
            # A pad-aligned payload's rows do not follow the radix tree's
            # token->position mapping: splicing leased pages in would
            # resume over WRONG KV. Drop the pin, import fully private.
            self.release_lease(deepest)
            matched_pages, deepest = [], None
        if lease is None and self.prefix_share and meta["left_aligned"]:
            matched_pages, deepest = self.radix.match_and_lease(ids)
        m = len(matched_pages)
        try:
            if reserve > self.max_seq_len:
                raise MigrationCompatError(
                    f"reserve_tokens {reserve} exceeds this cache's per-slot "
                    f"bound {self.max_seq_len}")
            if m * self.page_size < skip:
                raise MigrationCompatError(
                    f"payload ships rows only past token {skip} (prefix by "
                    f"reference) but this cache's radix tree holds "
                    f"{m * self.page_size} — re-export with the full page "
                    f"payload")
            rows = self._migration_rows(meta, lens, skip)
            new_pages = self._alloc_pages(self.pages_needed(reserve) - m)
        except BaseException:
            self.release_lease(deepest)
            raise
        used = self.pages_needed(lens)
        self.page_table[slot, :] = 0
        self.page_table[slot, :m] = matched_pages
        self.page_table[slot, m:m + len(new_pages)] = new_pages
        self.start[slot] = start
        self.lens[slot] = lens
        # Only pages [m, used) are written: matched pages already hold the
        # same bytes and the reserve tail is garbage until decode writes it
        # (tpudl points both at the trash page in its scatter).
        self._migration_scatter(rows, self.page_table[slot, m:used],
                                m * self.page_size - skip)
        tree_pages = 0
        node = None
        if self.radix is not None and meta["left_aligned"]:
            # The prompt's full pages enter the tree: a migrated-in system
            # prompt is as cacheable as a locally prefilled one.
            full = int(ids.shape[0]) // self.page_size
            if full > m:
                node = self.radix.insert_suffix(
                    deepest, self.radix.blocks_of(ids)[m:full],
                    [int(p) for p in self.page_table[slot, m:full]])
                tree_pages = full - m
        final = node if node is not None else deepest
        if final is not None:
            self._leases[slot] = final
        self._reserved[slot] = new_pages[tree_pages:]
        return meta

    def _migration_rows(self, meta: dict, lens: int, skip: int) -> dict:
        """The payload's rows by pool path, each validated against THIS
        cache's pool geometry (tail dims and stored dtype)."""
        arrays = meta["_arrays"]
        rows = {}
        for path, pool in _pool_leaves(self.cache):
            src = arrays.get(path)
            if src is None:
                raise MigrationCompatError(
                    f"payload has no rows for {path} — exported from a "
                    f"different model geometry")
            want = (lens - skip,) + tuple(pool.shape[2:])
            if tuple(src.shape) != want or src.dtype != pool.dtype:
                raise MigrationCompatError(
                    f"{path}: payload rows {tuple(src.shape)}/"
                    f"{dtype_name(src.dtype)} do not fit this cache's "
                    f"{want}/{dtype_name(pool.dtype)}")
            rows[path] = src
        return rows

    def _migration_scatter(self, rows: dict, pages, first: int) -> None:
        """Write the payload rows into ``pages`` of every pool, in place:
        page ``i`` takes rows ``[first + i * page_size, ...)`` (``first``
        is the first page's logical start minus the payload's first row);
        rows past the payload's end are zeros."""
        n, ps = len(pages), self.page_size
        if n == 0:
            return
        for path, pool in _pool_leaves(self.cache):
            src = rows[path][first:first + n * ps]
            block = pool.new_zeros((n * ps,) + tuple(pool.shape[2:]))
            block[:src.shape[0]] = src.to(pool.device)
            ids = torch.as_tensor(np.asarray(pages, np.int64),
                                  device=pool.device)
            pool[ids] = block.view(n, ps, *pool.shape[2:])

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


# ---------------------------------------------------------------------------
# Page-granular KV migration: the transfer format
# ---------------------------------------------------------------------------

MIGRATION_MAGIC = b"TPUDLMIG"
MIGRATION_VERSION = 1
_MIGRATION_HEADER = struct.Struct("<II")  # (version, meta length)


class MigrationCorruptError(RuntimeError):
    """A migration payload failed validation (bad magic or version, crc32
    mismatch, truncated array region): the request must NOT be resumed
    from it. The engine sheds it as ``failed``."""


class MigrationCompatError(ValueError):
    """A valid payload that cannot seat in THIS cache: quantization or
    model-geometry mismatch, a reservation past the per-slot bound, or a
    reference-only prefix the target's radix tree no longer holds. The
    caller's fallback is a from-scratch resubmission."""


def _pool_leaves(cache: dict, path=()) -> List[Tuple[str, torch.Tensor]]:
    """(path, pool tensor) of a paged cache in tpudl's payload order: keys
    sorted at every level (as jax flattens a dict), each path spelled as
    ``jax.tree_util.keystr`` spells it (``['model']['layer_0']...``)."""
    out = []
    for key in sorted(cache):
        value = cache[key]
        if isinstance(value, dict):
            out.extend(_pool_leaves(value, path + (key,)))
        else:
            out.append(("".join(f"[{k!r}]" for k in path + (key,)), value))
    return out


def _leaf_buffer(arr) -> Tuple[list, str, np.ndarray]:
    """(shape, numpy dtype name, C-order bytes as a uint8 array) of a
    payload leaf: a torch tensor (its raw words; bfloat16 under numpy's
    name) or a numpy array. Like tpudl's ``np.ascontiguousarray``, a 0-d
    leaf ships as shape [1]."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dim() == 0:
            t = t.reshape(1)
        flat = t.reshape(-1)
        raw = (flat.view(torch.uint8) if flat.numel()
               else torch.empty(0, dtype=torch.uint8))
        return list(t.shape), dtype_name(t.dtype), raw.numpy()
    arr = np.ascontiguousarray(arr)
    return list(arr.shape), arr.dtype.name, arr.reshape(-1).view(np.uint8)


def pack_migration(meta: dict, leaves) -> bytes:
    """One request's migration payload, byte for byte tpudl's: ``MAGIC |
    version | meta length | meta json | raw leaf buffers | crc32``.
    ``leaves`` is an ordered list of ``(path, tensor or ndarray)``; their
    descriptors (path, shape, dtype, offset, nbytes) land in the meta.
    The crc32 covers everything before it, so a truncation or bit flip
    anywhere is caught before a row is resumed."""
    descs = []
    bufs = []
    offset = 0
    for path, arr in leaves:
        shape, dtype, raw = _leaf_buffer(arr)
        descs.append({
            "path": path,
            "shape": shape,
            "dtype": dtype,
            "offset": offset,
            "nbytes": int(raw.nbytes),
        })
        bufs.append(raw)
        offset += raw.nbytes
    meta = dict(meta)
    meta["arrays"] = descs
    blob = json.dumps(meta).encode()
    body = b"".join([MIGRATION_MAGIC,
                     _MIGRATION_HEADER.pack(MIGRATION_VERSION, len(blob)),
                     blob, *bufs])
    return body + struct.pack("<I", zlib.crc32(body))


def parse_migration(payload) -> dict:
    """Decode and VERIFY a migration payload (the port's or tpudl's).
    Raises ``MigrationCorruptError`` on anything that fails the magic,
    version, crc32 or array-bounds checks. Returns the meta dict with
    ``"_arrays"`` holding the ``{path: CPU tensor}`` leaves (bfloat16
    leaves as ``torch.bfloat16``)."""
    head = len(MIGRATION_MAGIC) + _MIGRATION_HEADER.size
    if not isinstance(payload, (bytes, bytearray, memoryview)):
        raise TypeError(
            f"migration payload must be bytes, got {type(payload).__name__}")
    payload = bytes(payload)
    if len(payload) < head + 4 or payload[:len(MIGRATION_MAGIC)] != (
            MIGRATION_MAGIC):
        raise MigrationCorruptError(
            "not a tpudl migration payload (bad magic or truncated)")
    (crc,) = struct.unpack("<I", payload[-4:])
    if zlib.crc32(payload[:-4]) != crc:
        raise MigrationCorruptError(
            "crc32 mismatch — truncated or corrupted migration payload; "
            "refusing to resume from it")
    version, blob_len = _MIGRATION_HEADER.unpack(
        payload[len(MIGRATION_MAGIC):head])
    if version != MIGRATION_VERSION:
        raise MigrationCorruptError(
            f"migration payload version {version} != {MIGRATION_VERSION}")
    try:
        meta = json.loads(payload[head:head + blob_len].decode())
    except Exception as e:
        raise MigrationCorruptError(
            f"unreadable migration meta: {type(e).__name__}: {e}") from None
    # One writable copy of the array region: the tensors view into it.
    data = bytearray(payload[head + blob_len:-4])
    arrays = {}
    for desc in meta.get("arrays", []):
        offset, nbytes = desc["offset"], desc["nbytes"]
        if offset + nbytes > len(data):
            raise MigrationCorruptError(
                f"array region truncated: {desc['path']} ends at byte "
                f"{offset + nbytes}, payload holds {len(data)}")
        try:
            dtype = torch_dtype(desc["dtype"])
        except Exception:
            raise MigrationCorruptError(
                f"unknown leaf dtype {desc['dtype']!r} in migration "
                f"meta") from None
        if nbytes == 0:
            t = torch.empty(desc["shape"], dtype=dtype)
        else:
            aligned = offset % dtype.itemsize == 0
            raw = data if aligned else bytearray(data[offset:offset + nbytes])
            t = torch.frombuffer(raw, dtype=dtype,
                                 count=nbytes // dtype.itemsize,
                                 offset=offset if aligned else 0)
            t = t.reshape(desc["shape"])
        arrays[desc["path"]] = t
    meta["_arrays"] = arrays
    return meta
