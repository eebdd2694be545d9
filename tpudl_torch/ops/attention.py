"""Attention ops: the seam the port's transformer models go through.

The port's counterpart of tpudl.ops.attention. ``dot_product_attention``
is the reference implementation (bf16 batched products, f32 softmax) and
``attend`` dispatches by implementation name: ``"reference"``,
``"fused"`` (at S <= 256 tpudl_torch.ops.softmax_dropout's
``hybrid_attention``, up to 512 tpudl_torch.ops.fused_attention's
whole-row kernels, above 512 flash, as tpudl dispatches), and
``"flash"`` (tpudl_torch.ops.flash_attention) are ported; ``"ring"`` and
``"ulysses"`` raise until their kernels land.

Shapes follow the JAX package:
  q, k, v: [batch, seq, heads, head_dim]   (BSHD)
  mask:    broadcastable to [batch, heads, q_seq, kv_seq], True = attend
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpudl_torch.ops.dropout import dropout_keep_mask, quantized_rate

#: Large negative fill for masked logits, safe in bf16 — the same finite
#: value as tpudl.ops.attention.MASK_VALUE.
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

#: Implementations of tpudl's ``attend`` not ported yet, with the
#: ROADMAP item that ports each.
_NOT_PORTED = {
    "ring": "queue A item 10 (ring attention)",
    "ulysses": "queue A item 10 (Ulysses attention)",
}


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    dropout_exact: bool = False,
) -> torch.Tensor:
    """Reference attention: q [B, Sq, H, D], k, v [B, Skv, H, D] ->
    [B, Sq, H, D]. The dtype order is tpudl's: the product in the inputs'
    dtype times ``scale`` in that dtype, then f32, the mask, an f32
    softmax, the weights back in ``v``'s dtype, attention-probability
    dropout (when ``dropout_rng`` is given), and the second product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, MASK_VALUE)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = dropout_keep_mask(dropout_rng, weights.shape, dropout_rate,
                                 exact=dropout_exact, device=weights.device)
        eff = quantized_rate(dropout_rate, dropout_exact)
        weights = torch.where(keep, weights / (1.0 - eff), 0.0).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def causal_mask(q_len: int, kv_len: int, device="cuda") -> torch.Tensor:
    """[1, 1, q_len, kv_len] lower-triangular mask (True = attend)."""
    i = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    j = torch.arange(kv_len, device=device)[None, :]
    return (j <= i)[None, None, :, :]


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, Skv] 1/0 padding mask -> [B, 1, 1, Skv] boolean attend-mask."""
    return attention_mask[:, None, None, :].bool()


def normalize_kv_mask(
    mask: Optional[torch.Tensor],
    batch: int,
    kv_len: int,
    dtype=torch.int32,
    impl: str = "attention",
    device="cuda",
) -> torch.Tensor:
    """The kv-validity-mask contract of the kernel-backed
    implementations: None -> all ones (on ``device``); [B, 1, 1, S]
    padding masks squeeze to [B, S]; dense [B, H, Sq, Skv] masks raise
    NotImplementedError (only the reference implementation takes
    those)."""
    if mask is None:
        return torch.ones((batch, kv_len), dtype=dtype, device=device)
    if mask.dim() == 4:
        if mask.shape[1] != 1 or mask.shape[2] != 1:
            raise NotImplementedError(
                f"{impl} supports [B, S] / [B, 1, 1, S] padding masks and "
                f"causal=True; got dense mask {tuple(mask.shape)} — use "
                f"implementation='reference'"
            )
        mask = mask[:, 0, 0, :]
    return torch.broadcast_to(mask, (batch, kv_len)).to(dtype)


def combine_kv_causal_mask(
    mask: Optional[torch.Tensor], q_len: int, kv_len: int, causal: bool,
    device="cuda",
) -> Optional[torch.Tensor]:
    """Lift a [B, Skv] kv-validity row to [B, 1, 1, Skv] (4-D masks pass
    through), then AND in the causal triangle when asked. Returns None
    when nothing masks. ``device`` places the triangle when there is no
    mask to take it from."""
    if mask is not None and mask.dim() == 2:
        mask = padding_mask(mask)
    if causal:
        tri = causal_mask(q_len, kv_len,
                          mask.device if mask is not None else device)
        mask = tri if mask is None else mask.bool() & tri
    return mask


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    implementation: str = "reference",
    causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    dropout_exact: bool = False,
) -> torch.Tensor:
    """Dispatch to an attention implementation:

    - "reference": this module's batched-product attention;
    - "fused": at S <= 256, ``hybrid_attention`` (plain batched products
      around the softmax+dropout kernel on CUDA tensors, its plain
      version on CPU tensors), as tpudl's "fused" at short sequence; up
      to S = 512, ``fused_attention`` (the whole-row kernels; their
      plain versions on CPU tensors); above 512 it falls through to
      "flash", as tpudl's does;
    - "flash": ``flash_attention`` (the kernels on CUDA tensors, their
      plain versions on CPU tensors);
    - "ring", "ulysses" raise NotImplementedError naming their item.

    ``dropout_exact`` (bernoulli masks) is the reference path's only."""
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError(
            "dropout_rate > 0 requires a dropout_rng (dropout would "
            "otherwise be silently skipped)"
        )
    if dropout_exact and dropout_rate > 0.0 and implementation != "reference":
        raise ValueError(
            "dropout_exact (bernoulli masks) is only available on "
            "implementation='reference'; the fused kernel draws its mask "
            "from the Philox contract (tpudl_torch.ops.keep_mask)"
        )
    if implementation == "reference":
        mask = combine_kv_causal_mask(mask, q.shape[1], k.shape[1], causal,
                                      q.device)
        return dot_product_attention(
            q, k, v, mask, dropout_rate=dropout_rate,
            dropout_rng=dropout_rng, dropout_exact=dropout_exact,
        )
    if implementation == "fused":
        seq = q.shape[1]
        if seq <= 256:
            from tpudl_torch.ops.softmax_dropout import hybrid_attention

            return hybrid_attention(
                q, k, v, mask=mask, causal=causal, dropout_rate=dropout_rate,
                dropout_rng=dropout_rng,
            )
        from tpudl_torch.ops.fused_attention import MAX_SEQ, fused_attention

        if seq <= MAX_SEQ:
            return fused_attention(
                q, k, v, mask=mask, causal=causal, dropout_rate=dropout_rate,
                dropout_rng=dropout_rng,
            )
        implementation = "flash"
    if implementation == "flash":
        from tpudl_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, mask=mask, causal=causal, dropout_rate=dropout_rate,
            dropout_rng=dropout_rng,
        )
    if implementation in _NOT_PORTED:
        raise NotImplementedError(
            f"attention implementation {implementation!r} is not ported to "
            f"tpudl_torch yet: ROADMAP {_NOT_PORTED[implementation]}"
        )
    raise ValueError(f"unknown attention implementation {implementation!r}")
