"""Paged KV-cache primitives: the page-table view, the write and the
gather.

The port's counterpart of tpudl.models.paged. The dense decode cache
holds ``[num_slots, max_seq_len, Hkv, D]`` per layer and one write
index shared by every slot; the paged layout replaces both:

- KV lives in a pool of fixed-size pages ``[num_pages, page_size, Hkv,
  D]`` per layer; slot ``b`` owns the pages its page-table row maps
  (logical page ``j`` -> physical page ``page_table[b, j]``).
- Each slot carries its own length: decode writes row ``b`` at its own
  logical position ``lens[b]``, so no horizon is shared and the engine
  never rolls the cache over.

Slot ``b`` attends logical positions ``[start[b], lens[b] + j]`` for
query ``j`` of a chunk (``start`` = its left-pad count). Physical page
ids play no part in masking: the table is address translation, kept on
the host and shipped into each decode call as a small tensor.

Physical page 0 is the trash page: free slots' rows point at it, so an
idle slot's ride-along write lands where no live slot reads.

Pools may store int8 with a per-(page, row, head) f32 scale pool
``[num_pages, page_size, Hkv]`` beside them (``quantize_kv``, tpudl's
per-head symmetric quantizer over ``head_dim``): ``paged_write``
quantizes on the way in, ``paged_gather`` dequantizes on the way out,
into the compute dtype.

Unlike the JAX package, ``paged_write`` writes the pool (and its scale
pool) IN PLACE (no pool-sized copy per step), so both are graph-stable
buffers a captured decode step writes. The serving-side pool manager is
tpudl_torch.serve.cache.PagedKVCache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpudl_torch.quant.quantize import INT8_MAX, SCALE_EPS


@dataclasses.dataclass
class PagedView:
    """Per-dispatch paged-cache addressing, threaded through the model.

    ``page_table`` ([B, P] int64) maps slot b's logical page j to a
    physical pool page (0 = the trash page for unmapped entries);
    ``start`` ([B]) is slot b's first attendable logical position (its
    left-pad count); ``lens`` ([B]) is the logical position this step's
    token is written at. All three live on the pools' device. The row
    indices and the mask derived from them are the same for every layer
    of a call: each is computed once, at its first use, and kept."""

    page_table: torch.Tensor
    start: torch.Tensor
    lens: torch.Tensor
    page_size: int
    #: The pools store int8 with scale pools (tpudl's static flag).
    quantized: bool = False
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def logical_len(self) -> int:
        """Positions addressable per slot: pages_per_slot x page_size."""
        return int(self.page_table.shape[1]) * self.page_size

    def _memoized(self, key, make):
        if key not in self._memo:
            self._memo[key] = make()
        return self._memo[key]

    def write_rows(self, chunk: int) -> torch.Tensor:
        """[B, chunk] flat pool rows of this call's tokens: token j of slot
        b at logical position lens[b] + j, which past the table's capacity
        goes to the trash page (see ``paged_write``)."""

        def make():
            ps, p = self.page_size, self.page_table.shape[1]
            pos = self.lens[:, None] + torch.arange(chunk,
                                                    device=self.lens.device)
            pidx = pos // ps
            page = torch.gather(self.page_table, 1, pidx.clamp_max(p - 1))
            return torch.where(pidx < p, page, 0) * ps + pos % ps

        return self._memoized(("write", chunk), make)

    def gather_rows(self) -> torch.Tensor:
        """[B, L] flat pool rows of every slot's logical positions."""
        return self._memoized("gather", lambda: flat_page_row_index(
            self.page_table, self.page_size))


def flat_page_row_index(page_table: torch.Tensor, page_size: int):
    """Flat row index into a pool viewed as ``[NP * page_size, ...]``:
    logical position ``j`` of a table row maps to physical row
    ``table[..., j // ps] * ps + j % ps``. Takes ``[P]`` or ``[B, P]``;
    the trailing axis flattens to ``P * page_size``."""
    idx = (page_table[..., :, None] * page_size
           + torch.arange(page_size, device=page_table.device))
    return idx.reshape(*page_table.shape[:-1], -1)


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 quantization over the head_dim axis (tpudl's
    ``quantize_kv``): ``x`` [..., Hkv, D] -> (q int8 [..., Hkv, D], scale
    f32 [..., Hkv]), ``scale = max(max|x| / 127, SCALE_EPS)``, f32
    division, round half to even, clip to +-127."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / INT8_MAX).clamp_min(SCALE_EPS)
    q = (xf / scale[..., None]).round().clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def paged_write(pages: torch.Tensor, scales: Optional[torch.Tensor],
                value: torch.Tensor, view: PagedView):
    """Write a token chunk's k or v per slot into its current page rows,
    in place. ``pages`` [NP, ps, Hkv, D] (int8 or the compute dtype);
    ``scales`` [NP, ps, Hkv] f32 for int8 pools, else None; ``value`` [B,
    S, Hkv, D] (or [B, Hkv, D], the S = 1 form), quantized on the way in
    for int8 pools. Token j of slot b lands at physical
    ``(page_table[b, (lens[b] + j) // ps], (lens[b] + j) % ps)``; idle
    slots (lens 0 on a trash-mapped row) write into page 0. Positions
    past the table's logical capacity go to the trash page instead of
    clamping onto the slot's last page, whose kept rows a clamped write
    would corrupt. Returns ``(pages, scales)``."""
    if value.dim() == 3:
        value = value[:, None]
    rows = view.write_rows(value.shape[1])
    flat = pages.view(-1, *pages.shape[2:])
    if view.quantized:
        q, sc = quantize_kv(value)
        flat[rows] = q
        scales.view(-1, scales.shape[2])[rows] = sc
    else:
        flat[rows] = value.to(pages.dtype)
    return pages, scales


def paged_gather(pages: torch.Tensor, scales: Optional[torch.Tensor],
                 view: PagedView, compute_dtype: torch.dtype) -> torch.Tensor:
    """Every slot's logical KV view from the pool: [B, L, Hkv, D] in
    ``compute_dtype``, L = pages_per_slot x page_size; an int8 pool is
    dequantized (``q * scale`` in f32) in the gather. Unmapped logical
    pages resolve to the trash page: finite values the attention mask
    excludes."""
    rows = view.gather_rows()
    out = pages.view(-1, *pages.shape[2:])[rows]
    if view.quantized:
        out = out.float() * scales.view(-1, scales.shape[2])[rows][..., None]
    return out.to(compute_dtype)


def paged_attend_mask(view: PagedView, chunk: int = 1) -> torch.Tensor:
    """[B, 1, chunk, L] bool: query j of the chunk attends logical
    positions in [start, lens + j] inclusive (lens + j is where query j's
    own token was just written), so a chunk is causal within itself."""

    def make():
        pos = torch.arange(view.logical_len, device=view.lens.device)
        upper = view.lens[:, None] + torch.arange(chunk,
                                                  device=view.lens.device)
        mask = ((pos[None, None, :] >= view.start[:, None, None])
                & (pos[None, None, :] <= upper[:, :, None]))
        return mask[:, None, :, :]

    return view._memoized(("mask", chunk), make)
