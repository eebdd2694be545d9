"""Attention ops: the seam the port's transformer models go through.

The port's counterpart of tpudl.ops.attention. ``dot_product_attention``
is the reference implementation (bf16 batched products, f32 softmax) and
``attend`` dispatches by implementation name; only ``"reference"`` is
ported, and the Pallas-backed names raise until their kernels land.

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
    "fused": "queue B items 1 (softmax_dropout) and 6 (fused_attention)",
    "flash": "queue B item 5 (flash attention)",
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
    """Dispatch to an attention implementation: "reference" (this
    module's batched-product attention) is ported; "fused", "flash",
    "ring" and "ulysses" raise NotImplementedError naming their ROADMAP
    item."""
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError(
            "dropout_rate > 0 requires a dropout_rng (dropout would "
            "otherwise be silently skipped)"
        )
    if implementation in _NOT_PORTED:
        raise NotImplementedError(
            f"attention implementation {implementation!r} is not ported to "
            f"tpudl_torch yet: ROADMAP {_NOT_PORTED[implementation]}"
        )
    if implementation != "reference":
        raise ValueError(f"unknown attention implementation {implementation!r}")
    mask = combine_kv_causal_mask(mask, q.shape[1], k.shape[1], causal,
                                  q.device)
    return dot_product_attention(
        q, k, v, mask, dropout_rate=dropout_rate, dropout_rng=dropout_rng,
        dropout_exact=dropout_exact,
    )
