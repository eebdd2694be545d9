"""Whole-row attention at 256 < S <= 512: the Hopper kernels, their plain
versions and the autograd wrapper.

The port's counterpart of tpudl.ops.fused_attention. tpudl's TPU kernel
holds a head's whole [S, S] f32 score tile in VMEM and computes the full
softmax in one cell, with a one-pass backward that recomputes the
probabilities and emits dq, dk and dv together. The kernels are
``csrc/fused_attention.cu``: ``tpudl_fused_attn_fwd`` replaces
``_fwd_kernel`` (site 12) and ``tpudl_fused_attn_bwd`` replaces
``_bwd_kernel`` (site 13). The forward (one launch) computes each
row's softmax exactly (the max, then the exp-sum, then P·V over the
normalized probabilities, as the TPU kernel does, with no online
rescaling) and keeps for the backward the row statistic ``lse`` ([B, H,
S] f32). The backward recomputes p from lse in two launches in stream
order: the dQ launch forms the row term ``delta = rowsum(dp * p)`` and
then dq, the dK/dV launch reads that delta and forms dk and dv. With
dropout in bf16 the dQ launch also writes the keep bits it draws (a bit
per pair, 12.6 MB at BERT-base's seq-512 step) to a scratch tensor the
dK/dV launch reads instead of drawing them again.

The rounding points are the TPU kernel's: f32 logits and softmax; the
probabilities divided by the row sum and (with dropout) scaled by
1 / (1 - rate) in f32, then rounded to v's dtype for P·V; in the
backward ``do`` cast to q's dtype, dp taken against the dropped
probabilities, ``delta = rowsum(dp * p)`` summed in f32 inside the
kernel as the TPU kernel sums it, ``ds = p (dp - delta) scale`` on the
undropped p rounded to q's dtype before both its products, and the
dropped probabilities rounded to do's dtype for dV. (Taken instead as
``sum(do * o)`` from the bf16 o, as flash takes it, delta's error is
coherent along the row and ``dp - delta`` magnifies it: the q and k
gradients of a 2-layer BERT-base at seq 512 lay 1.2-1.7x further from
an f32 oracle than the plain path's, on an H100 and in the plain
versions on a CPU.) Masked
logits hold MASK_VALUE and a row that keeps nothing gives p = 0 and
o = 0. tpudl pads S to a multiple of 128 and masks the padded columns;
the kernels and the plain versions bound-check instead, with the same
result.

``fused_attention_ref`` and ``fused_attention_bwd_ref`` are the plain
PyTorch versions beside them: they compute what the kernels compute,
on CPU tensors and as the card's yardstick. Dispatch follows
tpudl_torch.ops.norms.resolve_impl: the kernels on CUDA tensors, the
plain versions on CPU tensors, no fallback. ``fused_attention_fwd.launches``
counts forward launches and ``fused_attention_bwd.launches`` backward
calls (two launches each).

Dropout follows the contract of tpudl_torch.ops.keep_mask at element
index ((b * H + h) * S + q) * S + kv of the [B, H, S, S] tensor, two
seed words drawn per call from the step's generator, so the mask is
bitwise flash's and ``hybrid_attention``'s on the same seed words; the
backward regenerates it. tpudl's TPU kernel draws from the hardware
PRNG, so dropout is compared with tpudl by distribution only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.attention import MASK_VALUE, normalize_kv_mask
from tpudl_torch.ops.flash_attention import HEAD_DIMS, _logits_keep, keep_scratch
from tpudl_torch.ops.keep_mask import draw_seed, keep_mask, threshold, zero_seed
from tpudl_torch.ops.norms import KERNEL_DTYPES, check_cuda_operand, resolve_impl

#: Longest sequence the whole-row design takes (tpudl's MAX_SEQ); past it
#: ``attend("fused")`` runs flash.
MAX_SEQ = 512


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kvmask: Optional[torch.Tensor], seed: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        rate: float = 0.0):
    """Plain version of the forward kernel: ``(o [B, S, H, D] in q's
    dtype, lse [B, H, S] f32)``. ``kvmask``: [B, S] bool or None;
    ``seed``: the int64 [2] seed words."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, keep = _logits_keep(q, k, kvmask, causal, scale)
    if keep is not None:
        s = torch.where(keep, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l_sum = p.sum(-1, keepdim=True)
    l_safe = torch.where(l_sum > 0.0, l_sum, 1.0)
    p = p / l_safe
    if rate > 0.0:
        kd = keep_mask(seed, p.shape, rate, device=p.device)
        p = torch.where(kd, p * (1.0 / (1.0 - rate)), 0.0)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def fused_attention_bwd_ref(q, k, v, kvmask, seed, do, lse, causal=False,
                            scale=None, rate=0.0):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` from the
    forward's row statistic ``lse`` [B, H, S]; ``do`` in q's dtype. p is
    recomputed from lse, dp taken against the dropped probabilities and
    ``delta = rowsum(dp * p)`` formed in f32, as the TPU kernel forms
    it."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, keep = _logits_keep(q, k, kvmask, causal, scale)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    pd = p
    if rate > 0.0:
        kd = keep_mask(seed, p.shape, rate, device=p.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(kd, dp * inv, 0.0)
        pd = torch.where(kd, p * inv, 0.0)
    delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("fused_attention")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        u32, f32 = ctypes.c_uint32, ctypes.c_float
        tail = [i32, i32, i32, i32, i32, f32, u32, f32, i32, i32, p]
        lib.tpudl_fused_attn_fwd.argtypes = [p] * 7 + tail
        lib.tpudl_fused_attn_fwd.restype = i32
        lib.tpudl_fused_attn_bwd.argtypes = [p] * 12 + tail
        lib.tpudl_fused_attn_bwd.restype = i32
        _lib = lib
    return _lib


def _operand(t, name, device, dtype):
    """A contiguous, 16-byte aligned copy of ``t`` where it is not one
    already (the kernels read rows as 16-byte vectors)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    check_cuda_operand(t, name, device, dtype)
    return t


def _check(q, k, v, kvmask, seed):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_attention takes [B, S, H, D] q, k and v of "
                         f"one shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    b, s, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"fused_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if s > MAX_SEQ:
        raise ValueError(f"fused_attention kernel takes S <= {MAX_SEQ}, "
                         f"got {s}")
    device = q.device
    q, k, v = (_operand(t, n, device, q.dtype)
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    check_cuda_operand(seed, "seed", device, torch.int64)
    if seed.shape != (2,) or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int64 [2] tensor")
    if kvmask is not None:
        check_cuda_operand(kvmask, "kvmask", device, torch.bool)
        if kvmask.shape != (b, s) or not kvmask.is_contiguous():
            raise ValueError(f"kvmask must be a contiguous [{b}, {s}] bool "
                             f"tensor")
    return q, k, v


def _tail(q, causal, scale, rate):
    b, s, h, d = q.shape
    return (b, s, h, d, int(causal), float(scale), threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0), KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_cuda(q, k, v, kvmask, seed, causal, scale, rate):
    q, k, v = _check(q, k, v, kvmask, seed)
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    if not o.numel():
        return o, lse
    lib = _kernel()
    code = lib.tpudl_fused_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvmask),
        seed.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_tail(q, causal, scale, rate))
    _build.check(lib, "fused_attn_fwd", code)
    fused_attention_fwd.launches += 1
    return o, lse


def _bwd_cuda(q, k, v, kvmask, seed, do, lse, causal, scale, rate,
              bits=None):
    """The two backward launches; ``bits``: flash_attention's
    ``keep_scratch`` of q and k to hand the keep bits over in (one is
    allocated when None)."""
    q, k, v = _check(q, k, v, kvmask, seed)
    device = q.device
    do = _operand(do, "do", device, q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q shape "
                         f"{tuple(q.shape)}")
    b, s, h, _ = q.shape
    lse = _operand(lse, "lse", device, torch.float32)
    if lse.shape != (b, h, s):
        raise ValueError(f"lse must be [{b}, {h}, {s}]")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not q.numel():
        return dq, dk, dv
    # The row term the dQ launch writes and the dK/dV launch reads, and
    # (bf16, dropout) the keep bits the dQ launch draws for the dK/dV
    # launch: a bit per (q, kv) in 32-bit words.
    delta = torch.empty_like(lse)
    if bits is None:
        bits = keep_scratch(q, k, rate)
    elif tuple(bits.shape) != (b, h, s, -(-s // 32)) or \
            bits.dtype != torch.int32 or not bits.is_contiguous():
        raise ValueError("bits must be keep_scratch's tensor")
    lib = _kernel()
    code = lib.tpudl_fused_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvmask),
        seed.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(bits), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, causal, scale, rate))
    _build.check(lib, "fused_attn_bwd", code)
    fused_attention_bwd.launches += 1
    return dq, dk, dv


def fused_attention_fwd(q, k, v, kvmask, seed, causal=False, scale=None,
                        rate=0.0, *, impl: str = "auto"):
    """The forward kernel on CUDA tensors, ``fused_attention_ref`` on CPU
    tensors: ``(o, lse)``. Arguments as ``fused_attention_ref``."""
    threshold(rate)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not resolve_impl(impl, q.device):
        return fused_attention_ref(q, k, v, kvmask, seed, causal, scale, rate)
    return _fwd_cuda(q, k, v, kvmask, seed, causal, scale, rate)


def fused_attention_bwd(q, k, v, kvmask, seed, do, lse, causal=False,
                        scale=None, rate=0.0, *, impl: str = "auto"):
    """The backward kernels on CUDA tensors (the dQ and dK/dV launches of
    one call: ``launches`` counts the call once),
    ``fused_attention_bwd_ref`` on CPU tensors: ``(dq, dk, dv)``.
    Arguments as ``fused_attention_bwd_ref``."""
    threshold(rate)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not resolve_impl(impl, q.device):
        return fused_attention_bwd_ref(q, k, v, kvmask, seed, do, lse,
                                       causal, scale, rate)
    return _bwd_cuda(q, k, v, kvmask, seed, do, lse, causal, scale, rate)


fused_attention_fwd.launches = 0
fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    """tpudl's ``_fused`` custom_vjp: the forward saves q, k, v, the kv
    mask, the seed words and the row statistic lse; the backward runs the
    backward kernels (their plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, kvmask, seed, causal, scale, rate, impl):
        o, lse = fused_attention_fwd(q, k, v, kvmask, seed, causal, scale,
                                     rate, impl=impl)
        ctx.causal, ctx.scale, ctx.rate, ctx.impl = causal, scale, rate, impl
        ctx.save_for_backward(q, k, v, kvmask, seed, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, kvmask, seed, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(
            q, k, v, kvmask, seed, g.to(q.dtype), lse, ctx.causal, ctx.scale,
            ctx.rate, impl=ctx.impl)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    head_group: Optional[int] = None,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Whole-row self-attention on [B, S, H, D] (the contract of
    ``dot_product_attention``; tpudl's signature). ``mask``: a [B, S]
    kv-validity row or a [B, 1, 1, S] padding mask (dense masks raise
    NotImplementedError: use implementation='reference'). ``head_group``
    is tpudl's VMEM-packing knob: validated (it must divide H), not
    used. ``dropout_rate`` > 0 needs ``dropout_rng``, a
    ``torch.Generator`` on the inputs' device, from which each call
    draws two seed words. ``impl``: see tpudl_torch.ops.norms."""
    b, s, h, d = q.shape
    if k.shape[1] != s:
        raise ValueError(
            f"fused_attention is self-attention-shaped (Sq == Skv); got "
            f"Sq={s}, Skv={k.shape[1]} — use flash_attention")
    if s > MAX_SEQ:
        raise ValueError(
            f"fused_attention computes whole [S, S] rows; S={s} > "
            f"{MAX_SEQ} — use implementation='flash'")
    if head_group is not None and (head_group < 1 or h % head_group):
        raise ValueError(f"head_group {head_group} does not divide {h} heads")
    if scale is None:
        scale = d ** -0.5
    threshold(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires dropout_rng")
        seed = draw_seed(dropout_rng)
    else:
        seed = zero_seed(q.device)
    kvmask = None
    if mask is not None:
        kvmask = normalize_kv_mask(mask, b, s, dtype=torch.bool,
                                   impl="fused_attention",
                                   device=q.device).contiguous()
    return _FusedAttention.apply(q, k, v, kvmask, seed, causal, float(scale),
                                 float(dropout_rate), impl)
