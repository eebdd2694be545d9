"""Flash attention: memory-linear attention with an online softmax — the
Hopper kernels, their plain versions and the autograd wrapper.

The port's counterpart of tpudl.ops.flash_attention. The kernels are
``csrc/flash_attention.cu``: ``tpudl_flash_fwd`` replaces ``_fwd_kernel``
(o and the per-row logsumexp), ``tpudl_flash_dq`` replaces ``_dq_kernel``
and ``tpudl_flash_dkv`` replaces ``_dkv_kernel``; the backward recomputes
the probabilities from the saved logsumexp, so nothing of size
[B, H, Sq, Skv] is ever stored. ``flash_attention_ref`` and
``flash_attention_bwd_ref`` are the plain PyTorch versions beside them:
they compute what the kernels compute (f32 logits, softmax and
accumulation; both products on operands of the inputs' dtype, the
probabilities and ds rounded to it first), not
``dot_product_attention``'s numbers. In particular a query row that
attends to nothing gives o = 0 and lse = MASK_VALUE, as tpudl's kernel
does, where the reference softmax would spread it uniformly.

Semantics, as tpudl's kernel: q [B, Sq, H, D], k, v [B, Skv, H, D];
masks are a [B, Skv] kv-validity row or a [B, 1, 1, Skv] padding mask
(dense masks raise NotImplementedError); causal masking is bottom-right
aligned (kv <= q + Skv - Sq) and the kernels skip kv tiles that cannot
contribute; ragged Sq and Skv are bounds checks in the kernels. The
kernels take head dims 32, 64 and 128 and raise on any other.

Dropout follows the contract of tpudl_torch.ops.keep_mask (the bits of
element i of the unpadded [B, H, Sq, Skv] tensor are word i mod 4 of
Philox4x32-10 at counter i // 4 under two seed words drawn per call from
the step's generator): the softmax denominator stays undropped (dropout
applies after normalization), o is scaled by 1 / (1 - rate), and the
backward regenerates the same mask: in bf16 the dQ launch draws it and
hands its words to the dK/dV launch through a scratch (``keep_scratch``,
the layout of ``keep_mask.keep_words``); the f32 kernels each draw it.
The mask is bitwise the one ``hybrid_attention`` draws for the same seed
words. Its bits are not the
TPU's (tpudl's flash draws dropout only on a TPU).

The autograd Function saves what tpudl's ``_flash_fwd`` saves (q, k, v,
the kv mask, the seed words, o and lse). ``delta = sum(do * o)`` — ``do``
cast to q's dtype first, the lse cotangent subtracted — is a PyTorch
reduction outside the kernels (tpudl's ``_bwd_core``). The two backward
kernels stay separate launches, so each accumulator has one owner: no
float atomics, and the backward is bitwise repeatable.

Dispatch follows tpudl_torch.ops.norms.resolve_impl: the kernels on CUDA
tensors, the plain versions on CPU tensors, no fallback.
``flash_attention.launches_fwd``, ``.launches_dq`` and ``.launches_dkv``
count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.attention import MASK_VALUE, normalize_kv_mask
from tpudl_torch.ops.keep_mask import draw_seed, keep_mask, threshold, zero_seed
from tpudl_torch.ops.norms import KERNEL_DTYPES, check_cuda_operand, resolve_impl

#: Head dims the kernels take.
HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _logits_keep(q, k, kvmask, causal, scale):
    """f32 logits [B, H, Sq, Skv] of bf16 (or f32) operands and the
    attend mask (None when nothing masks)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    keep = None
    if kvmask is not None:
        keep = kvmask.bool()[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        tri = torch.arange(skv, device=q.device)[None, :] <= qi
        keep = tri if keep is None else keep & tri
    return s, keep


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kvmask: Optional[torch.Tensor], seed: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        rate: float = 0.0):
    """Plain version of the forward kernel: ``(o [B, Sq, H, D] in q's
    dtype, lse [B, H, Sq] f32)``. ``kvmask``: [B, Skv] bool or None;
    ``seed``: the int64 [2] seed words."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, keep = _logits_keep(q, k, kvmask, causal, scale)
    if keep is not None:
        s = torch.where(keep, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True).clamp_min(MASK_VALUE)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l > 0.0, l, 1.0)
    if rate > 0.0:
        p = torch.where(keep_mask(seed, p.shape, rate, device=p.device), p, 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = acc / l_safe.permute(0, 2, 1, 3)
    if rate > 0.0:
        o = o * (1.0 / (1.0 - rate))
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, kvmask, seed, do, lse, delta,
                            causal=False, scale=None, rate=0.0):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` from
    the saved logsumexp ``lse`` [B, H, Sq] and ``delta`` [B, H, Sq] (=
    sum(do * o) minus the lse cotangent); ``do`` in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, keep = _logits_keep(q, k, kvmask, causal, scale)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    p_num = p
    if rate > 0.0:
        kd = keep_mask(seed, p.shape, rate, device=p.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(kd, dp * inv, 0.0)
        p_num = torch.where(kd, p * inv, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_num.to(do.dtype).float(),
                      do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        u32, f32 = ctypes.c_uint32, ctypes.c_float
        tail = [i32, i32, i32, i32, i32, i32, f32, u32, f32, i32, i32, p]
        lib.tpudl_flash_fwd.argtypes = [p] * 7 + tail
        lib.tpudl_flash_fwd.restype = i32
        lib.tpudl_flash_dq.argtypes = [p] * 10 + tail
        lib.tpudl_flash_dq.restype = i32
        lib.tpudl_flash_dkv.argtypes = [p] * 11 + tail
        lib.tpudl_flash_dkv.restype = i32
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


def _check(q, k, v, kvmask, seed, op):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{op} takes [B, S, H, D] q, k and v")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{op} kernel takes float32 or bfloat16, got {q.dtype}")
    b, sq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{op} kernel takes head dims {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"{op}: k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    device = q.device
    q, k, v = (_operand(t, n, device, q.dtype)
               for t, n in ((q, "q"), (k, "k"), (v, "v")))
    check_cuda_operand(seed, "seed", device, torch.int64)
    if seed.shape != (2,) or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int64 [2] tensor")
    if kvmask is not None:
        check_cuda_operand(kvmask, "kvmask", device, torch.bool)
        if kvmask.shape != (b, k.shape[1]) or not kvmask.is_contiguous():
            raise ValueError(f"kvmask must be a contiguous [{b}, {k.shape[1]}] "
                             f"bool tensor")
    return q, k, v


def _tail(q, k, causal, scale, rate):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, d, int(causal), float(scale),
            threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0),
            KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_cuda(q, k, v, kvmask, seed, causal, scale, rate):
    q, k, v = _check(q, k, v, kvmask, seed, "flash_attention")
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if not o.numel():
        return o, lse
    if k.shape[1] == 0:
        # Nothing to attend to: every row keeps nothing.
        return o.zero_(), lse.fill_(MASK_VALUE)
    lib = _kernel()
    code = lib.tpudl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvmask),
        seed.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_tail(q, k, causal, scale, rate))
    _build.check(lib, "flash_fwd", code)
    flash_attention.launches_fwd += 1
    return o, lse


def bwd_operands(q, k, v, kvmask, seed, do, lse, delta):
    """Check the backward kernels' operands; return ``(q, k, v, do, lse,
    delta)`` as the kernels take them (contiguous, 16-byte aligned)."""
    q, k, v = _check(q, k, v, kvmask, seed, "flash_attention_bwd")
    device = q.device
    do = _operand(do, "do", device, q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q shape "
                         f"{tuple(q.shape)}")
    lse = _operand(lse, "lse", device, torch.float32)
    delta = _operand(delta, "delta", device, torch.float32)
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq):
            raise ValueError(f"{name} must be [{b}, {h}, {sq}]")
    return q, k, v, do, lse, delta


def keep_scratch(q, k, rate):
    """The scratch a bf16 dQ launch (flash's or the whole-row attention's)
    writes its keep bits into and its dK/dV launch reads them from, with
    dropout: int32 [B, H, Sq, ceil(Skv / 32)] on q's device, in
    ``keep_mask.keep_words``' layout (words of pairs no query block
    reaches are left unwritten). None when the launches take none (no
    dropout, or f32)."""
    if not (rate > 0.0 and q.dtype == torch.bfloat16):
        return None
    b, sq, h, _ = q.shape
    return torch.empty(b, h, sq, -(-k.shape[1] // 32), dtype=torch.int32,
                       device=q.device)


def _bits(operands, rate, bits, op):
    """Check a launch's keep-bit scratch; return its address (or None)."""
    q, k = operands[:2]
    if bits is None:
        if rate > 0.0 and q.dtype == torch.bfloat16:
            raise ValueError(f"{op} with dropout in bf16 takes the keep-bit "
                             f"scratch (keep_scratch)")
        return None
    b, sq, h, _ = q.shape
    shape = (b, h, sq, -(-k.shape[1] // 32))
    check_cuda_operand(bits, "bits", q.device, torch.int32)
    if tuple(bits.shape) != shape or not bits.is_contiguous():
        raise ValueError(f"{op}: bits must be a contiguous {shape} int32 "
                         f"tensor")
    return bits.data_ptr()


def launch_dq(operands, kvmask, seed, causal, scale, rate, bits=None):
    """The dQ kernel on ``bwd_operands``' result: dq. With dropout in bf16
    it also writes the keep bits it draws into ``bits``
    (``keep_scratch``), which the dK/dV launch then reads."""
    q, k, v, do, lse, delta = operands
    bits_ptr = _bits(operands, rate, bits, "flash_dq")
    dq = torch.empty_like(q)
    if not (q.numel() and k.numel()):
        return dq.zero_()
    lib = _kernel()
    code = lib.tpudl_flash_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvmask),
        seed.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        bits_ptr, dq.data_ptr(), *_tail(q, k, causal, scale, rate))
    _build.check(lib, "flash_dq", code)
    flash_attention.launches_dq += 1
    return dq


def launch_dkv(operands, kvmask, seed, causal, scale, rate, bits=None):
    """The dK/dV kernel on ``bwd_operands``' result: (dk, dv). With
    dropout in bf16 it reads the keep bits a dQ launch on the same
    operands wrote into ``bits`` (in stream order before it)."""
    q, k, v, do, lse, delta = operands
    bits_ptr = _bits(operands, rate, bits, "flash_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if not (q.numel() and k.numel()):
        return dk.zero_(), dv.zero_()
    lib = _kernel()
    code = lib.tpudl_flash_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kvmask),
        seed.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        bits_ptr, dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, causal, scale, rate))
    _build.check(lib, "flash_dkv", code)
    flash_attention.launches_dkv += 1
    return dk, dv


def _bwd_cuda(q, k, v, kvmask, seed, do, lse, delta, causal, scale, rate):
    operands = bwd_operands(q, k, v, kvmask, seed, do, lse, delta)
    bits = keep_scratch(operands[0], operands[1], rate)
    dq = launch_dq(operands, kvmask, seed, causal, scale, rate, bits)
    return (dq, *launch_dkv(operands, kvmask, seed, causal, scale, rate,
                            bits))


def flash_attention_fwd(q, k, v, kvmask, seed, causal=False, scale=None,
                        rate=0.0, *, impl: str = "auto"):
    """The forward kernel on CUDA tensors, ``flash_attention_ref`` on CPU
    tensors: ``(o, lse)``. Arguments as ``flash_attention_ref``."""
    threshold(rate)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not resolve_impl(impl, q.device):
        return flash_attention_ref(q, k, v, kvmask, seed, causal, scale, rate)
    return _fwd_cuda(q, k, v, kvmask, seed, causal, scale, rate)


def flash_attention_bwd(q, k, v, kvmask, seed, do, lse, delta, causal=False,
                        scale=None, rate=0.0, *, impl: str = "auto"):
    """The dQ and dK/dV kernels on CUDA tensors (two launches),
    ``flash_attention_bwd_ref`` on CPU tensors: ``(dq, dk, dv)``.
    Arguments as ``flash_attention_bwd_ref``."""
    threshold(rate)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not resolve_impl(impl, q.device):
        return flash_attention_bwd_ref(q, k, v, kvmask, seed, do, lse, delta,
                                       causal, scale, rate)
    return _bwd_cuda(q, k, v, kvmask, seed, do, lse, delta, causal, scale,
                     rate)


def backward_delta(do: torch.Tensor, o: torch.Tensor,
                   dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, H, Sq] f32 ``sum(do * o)`` over the head dim, minus the lse
    cotangent: the row term both backward kernels take (tpudl's
    ``_bwd_core``)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


class _FlashAttention(torch.autograd.Function):
    """tpudl's ``_flash_lse`` custom_vjp: the forward saves q, k, v, the
    kv mask, the seed words, o and lse; the backward folds the lse
    cotangent into delta and runs the dQ and dK/dV kernels (their plain
    versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, kvmask, seed, causal, scale, rate, impl):
        ctx.set_materialize_grads(False)
        o, lse = flash_attention_fwd(q, k, v, kvmask, seed, causal, scale,
                                     rate, impl=impl)
        ctx.causal, ctx.scale, ctx.rate, ctx.impl = causal, scale, rate, impl
        ctx.save_for_backward(q, k, v, kvmask, seed, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, g, dlse):
        q, k, v, kvmask, seed, o, lse = ctx.saved_tensors
        do = torch.zeros_like(q) if g is None else g.to(q.dtype)
        delta = backward_delta(do, o, dlse)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, kvmask, seed, do, lse, delta, ctx.causal, ctx.scale,
            ctx.rate, impl=ctx.impl)
        return dq, dk, dv, None, None, None, None, None, None


def _call(q, k, v, mask, causal, scale, dropout_rate, dropout_rng, impl):
    """The shared preamble of the two public entry points: the scale
    default, the dropout contract and the kv-mask normalization."""
    b, _, _, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    threshold(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires a dropout_rng")
        seed = draw_seed(dropout_rng)
    else:
        seed = zero_seed(q.device)
    kvmask = None
    if mask is not None:
        kvmask = normalize_kv_mask(mask, b, skv, dtype=torch.bool,
                                   impl="flash_attention").contiguous()
    return _FlashAttention.apply(q, k, v, kvmask, seed, causal, float(scale),
                                 float(dropout_rate), impl)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    *,
    impl: str = "auto",
):
    """``flash_attention`` that also returns the per-query logsumexp
    ([B, H, Sq] f32, of the undropped distribution; MASK_VALUE for a row
    that attends to nothing). Differentiable in both outputs."""
    return _call(q, k, v, mask, causal, scale, dropout_rate, dropout_rng,
                 impl)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Flash attention on [B, S, H, D] inputs (the contract of
    ``dot_product_attention``, masks as the module docstring says).
    ``dropout_rate`` > 0 needs ``dropout_rng``, a ``torch.Generator`` on
    the inputs' device, from which each call draws two seed words.
    ``impl``: see tpudl_torch.ops.norms."""
    return _call(q, k, v, mask, causal, scale, dropout_rate, dropout_rng,
                 impl)[0]


flash_attention.launches_fwd = 0
flash_attention.launches_dq = 0
flash_attention.launches_dkv = 0
