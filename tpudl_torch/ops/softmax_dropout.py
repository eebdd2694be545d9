"""Fused masked softmax + attention dropout over [B, H, Sq, Skv] logits:
the Hopper kernels, their plain versions and the autograd wrapper.

The port's counterpart of tpudl.ops.softmax_dropout. At short sequence
the batched QK^T and PV products stay plain matrix products, and one
bandwidth-bound pass turns the logits into dropped probabilities: row
softmax in f32 registers, kv-validity and causal masking, and dropout
drawn inside the kernel, so the [B, H, Sq, Skv] keep mask never touches
device memory. The backward is one more pass: it re-reads the logits,
regenerates the same keep mask from the seed words and writes the
logits' gradient.

The kernels are ``csrc/softmax_dropout.cu``: ``tpudl_softmax_dropout_fwd``
replaces ``_fwd_kernel`` and ``tpudl_softmax_dropout_bwd`` replaces
``_bwd_kernel``. ``softmax_dropout_ref`` and ``softmax_dropout_bwd_ref``
are the plain PyTorch versions beside them. The keep mask is the
contract of tpudl_torch.ops.keep_mask: a pure function of two uint32
seed words (drawn per call from the step's ``torch.Generator``, kept on
the device), the shape and the element's flat index, so the kernels and
the plain versions draw the same mask bit for bit. Its bits are not the
TPU's.

Dispatch follows tpudl_torch.ops.norms.resolve_impl: the kernel on CUDA
tensors, the plain version on CPU tensors, no fallback. Rows longer than
``MAX_SKV`` raise ValueError on the kernel path.

``softmax_dropout.launches`` and ``softmax_dropout_bwd.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.attention import MASK_VALUE, normalize_kv_mask
from tpudl_torch.ops.keep_mask import draw_seed, keep_mask, threshold, zero_seed
from tpudl_torch.ops.norms import (
    KERNEL_DTYPES,
    check_cuda_operand,
    needs_grad,
    resolve_impl,
    takes_op,
)

#: The longest row (Skv) the kernels take: one warp holds it in registers.
MAX_SKV = 512


def _probs(logits, kvmask, causal):
    """The f32 pre-dropout probabilities of tpudl's ``_masked_softmax``:
    masked logits become MASK_VALUE, entries at or below it are 0 after
    the exp, and a row with nothing unmasked stays 0."""
    s = logits.float()
    if kvmask is not None:
        s = torch.where(kvmask[:, None, None, :], s, MASK_VALUE)
    if causal:
        sq, skv = s.shape[-2:]
        q = torch.arange(sq, device=s.device)[:, None] + (skv - sq)
        kv = torch.arange(skv, device=s.device)[None, :]
        s = torch.where(kv <= q, s, MASK_VALUE)
    m = s.amax(-1, keepdim=True)
    p = torch.where(s <= MASK_VALUE, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    return p / torch.where(l > 0.0, l, 1.0)


def softmax_dropout_ref(logits: torch.Tensor, kvmask: Optional[torch.Tensor],
                        seed: torch.Tensor, causal: bool = False,
                        rate: float = 0.0, out_dtype=torch.bfloat16):
    """Plain version of the forward kernel: ``logits`` [B, H, Sq, Skv],
    ``kvmask`` [B, Skv] bool (True = attend) or None, ``seed`` the int64
    [2] seed words. Returns the dropped probabilities in ``out_dtype``:
    ``keep ? p * (1 / (1 - rate)) : 0``."""
    p = _probs(logits, kvmask, causal)
    if rate > 0.0:
        keep = keep_mask(seed, p.shape, rate, device=p.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
    return p.to(out_dtype)


def softmax_dropout_bwd_ref(logits: torch.Tensor,
                            kvmask: Optional[torch.Tensor],
                            seed: torch.Tensor, g: torch.Tensor,
                            causal: bool = False, rate: float = 0.0):
    """Plain version of the backward kernel: recompute the probabilities
    p from the logits and the keep mask from the seed, then ``dx = p *
    (g' - <g', p>_row)`` with ``g' = keep ? g / (1 - rate) : 0``, in the
    logits' dtype."""
    p = _probs(logits, kvmask, causal)
    g = g.float()
    if rate > 0.0:
        keep = keep_mask(seed, p.shape, rate, device=p.device)
        g = torch.where(keep, g * (1.0 / (1.0 - rate)), 0.0)
    dx = p * (g - (g * p).sum(-1, keepdim=True))
    return dx.to(logits.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("softmax_dropout")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        u32, f32 = ctypes.c_uint32, ctypes.c_float
        lib.tpudl_softmax_dropout_fwd.argtypes = [
            p, p, p, p, i64, i64, i32, i32, i32, u32, f32, i32, i32, i32, p,
        ]
        lib.tpudl_softmax_dropout_fwd.restype = i32
        lib.tpudl_softmax_dropout_bwd.argtypes = [
            p, p, p, p, p, i64, i64, i32, i32, i32, u32, f32, i32, i32, i32, p,
        ]
        lib.tpudl_softmax_dropout_bwd.restype = i32
        _lib = lib
    return _lib


def _check(logits, kvmask, seed, op):
    """Check the operands the kernels share; return the contiguous
    logits."""
    if logits.dim() != 4:
        raise ValueError(f"{op} takes [B, H, Sq, Skv] logits, got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{op} kernel takes float32 or bfloat16 logits, got "
                         f"{logits.dtype}")
    b, _, _, skv = logits.shape
    if skv > MAX_SKV:
        raise ValueError(
            f"{op} kernel takes rows of at most {MAX_SKV} columns (one warp "
            f"per row), got Skv={skv}: longer rows go to flash_attention, "
            f"or to attend(\"fused\"), which sends S <= 512 to the "
            f"whole-row kernel (fused_attention) and longer rows to flash"
        )
    device = logits.device
    logits = logits.contiguous()
    check_cuda_operand(logits, "logits", device, logits.dtype)
    check_cuda_operand(seed, "seed", device, torch.int64)
    if seed.shape != (2,) or not seed.is_contiguous():
        raise ValueError("seed must be a contiguous int64 [2] tensor")
    if kvmask is not None:
        check_cuda_operand(kvmask, "kvmask", device, torch.bool)
        if kvmask.shape != (b, skv) or not kvmask.is_contiguous():
            raise ValueError(f"kvmask must be a contiguous [{b}, {skv}] bool "
                             f"tensor")
    return logits


def _launch_args(logits, kvmask, seed, causal, rate):
    b, h, sq, skv = logits.shape
    return (None if kvmask is None else kvmask.data_ptr(), seed.data_ptr(),
            b, h, sq, skv, int(causal), threshold(rate),
            1.0 / (1.0 - rate), int(rate > 0.0))


def _sd_fwd_cuda(logits, kvmask, seed, causal, rate, out_dtype):
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"softmax_dropout kernel writes float32 or bfloat16, "
                         f"got {out_dtype}")
    logits = _check(logits, kvmask, seed, "softmax_dropout")
    out = torch.empty(logits.shape, dtype=out_dtype, device=logits.device)
    if logits.numel():
        lib = _kernel()
        mask_ptr, seed_ptr, *rest = _launch_args(logits, kvmask, seed, causal,
                                                 rate)
        code = lib.tpudl_softmax_dropout_fwd(
            logits.data_ptr(), mask_ptr, seed_ptr, out.data_ptr(), *rest,
            KERNEL_DTYPES[logits.dtype], KERNEL_DTYPES[out_dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _build.check(lib, "softmax_dropout_fwd", code)
        softmax_dropout.launches += 1
    return out


def _sd_bwd_cuda(logits, kvmask, seed, g, causal, rate):
    logits = _check(logits, kvmask, seed, "softmax_dropout_bwd")
    if g.shape != logits.shape:
        raise ValueError(f"g shape {tuple(g.shape)} != logits shape "
                         f"{tuple(logits.shape)}")
    if g.dtype not in KERNEL_DTYPES:
        raise ValueError(f"softmax_dropout_bwd kernel takes a float32 or "
                         f"bfloat16 gradient, got {g.dtype}")
    # Autograd may hand over a gradient with any strides.
    g = g.contiguous()
    check_cuda_operand(g, "g", logits.device, g.dtype)
    dx = torch.empty_like(logits)
    if logits.numel():
        lib = _kernel()
        mask_ptr, seed_ptr, *rest = _launch_args(logits, kvmask, seed, causal,
                                                 rate)
        code = lib.tpudl_softmax_dropout_bwd(
            logits.data_ptr(), mask_ptr, seed_ptr, g.data_ptr(),
            dx.data_ptr(), *rest, KERNEL_DTYPES[logits.dtype],
            KERNEL_DTYPES[g.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _build.check(lib, "softmax_dropout_bwd", code)
        softmax_dropout_bwd.launches += 1
    return dx


def philox_pair_cuda(words: torch.Tensor):
    """philox.cuh's Philox4x32-10 and cuRAND's ``curand_Philox4x32_10`` on
    the card (the check library ``csrc/philox_check.cu``): ``words`` is an
    int64 [n, 6] tensor of uint32 values (counter words 0-3, key words
    0-1); returns both [n, 4] outputs as int64 CPU tensors."""
    n = words.shape[0]
    inp = words.to(torch.int32).contiguous().cuda()
    ours = torch.empty(n, 4, dtype=torch.int32, device=inp.device)
    theirs = torch.empty_like(ours)
    lib = _build.load("philox_check")
    lib.tpudl_philox_pair.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.tpudl_philox_pair.restype = ctypes.c_int
    code = lib.tpudl_philox_pair(inp.data_ptr(), ours.data_ptr(),
                                 theirs.data_ptr(), n,
                                 torch.cuda.current_stream(inp.device).cuda_stream)
    _build.check(lib, "philox_pair", code)
    return tuple(t.cpu().to(torch.int64) & 0xFFFFFFFF for t in (ours, theirs))


def softmax_dropout_bwd(logits, kvmask, seed, g, causal=False, rate=0.0, *,
                        impl: str = "auto"):
    """The backward of ``softmax_dropout`` from its logits, kv mask and
    seed words: the kernel on CUDA tensors, ``softmax_dropout_bwd_ref`` on
    CPU tensors. Arguments and result as ``softmax_dropout_bwd_ref``."""
    threshold(rate)
    if not resolve_impl(impl, logits.device):
        return softmax_dropout_bwd_ref(logits, kvmask, seed, g, causal, rate)
    return _sd_bwd_cuda(logits, kvmask, seed, g, causal, rate)


softmax_dropout_bwd.launches = 0


class _SoftmaxDropout(torch.autograd.Function):
    """tpudl's ``_sd`` custom_vjp: the forward kernel saves only the
    logits, the kv mask and the seed words; the backward kernel
    recomputes the probabilities and regenerates the keep mask."""

    @staticmethod
    def forward(ctx, logits, kvmask, seed, causal, rate, out_dtype):
        ctx.causal, ctx.rate = causal, rate
        ctx.save_for_backward(logits, kvmask, seed)
        return torch.ops.tpudl.softmax_dropout(logits, kvmask, seed, causal,
                                               rate, out_dtype)

    @staticmethod
    def backward(ctx, g):
        logits, kvmask, seed = ctx.saved_tensors
        dx = _sd_bwd_cuda(logits, kvmask, seed, g, ctx.causal, ctx.rate)
        return dx, None, None, None, None, None


def softmax_dropout(
    logits: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[torch.Generator] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Masked row softmax + attention dropout of [B, H, Sq, Skv] logits
    in one pass, probabilities returned in ``out_dtype``.

    ``mask``: a [B, Skv] kv-validity row or a [B, 1, 1, Skv] padding mask
    (a dense mask raises NotImplementedError). Causal masking is
    bottom-right aligned and needs Sq == Skv. ``dropout_rate`` > 0 needs
    ``dropout_rng``, a ``torch.Generator`` on the logits' device, from
    which each call draws two seed words; at rate 0 nothing is drawn.
    ``impl``: see tpudl_torch.ops.norms."""
    b, _, sq, skv = logits.shape
    if causal and sq != skv:
        raise ValueError(
            f"causal softmax_dropout expects Sq == Skv, got {sq} vs {skv}"
        )
    threshold(dropout_rate)
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires dropout_rng")
        seed = draw_seed(dropout_rng)
    else:
        seed = zero_seed(logits.device)
    kvmask = None
    if mask is not None:
        kvmask = normalize_kv_mask(mask, b, skv, dtype=torch.bool,
                                   impl="softmax_dropout").contiguous()
    if not takes_op(impl, logits.device, logits):
        return softmax_dropout_ref(logits, kvmask, seed, causal,
                                   float(dropout_rate), out_dtype)
    if logits.device.type == "cuda" and needs_grad(logits):
        return _SoftmaxDropout.apply(logits, kvmask, seed, causal,
                                     float(dropout_rate), out_dtype)
    return torch.ops.tpudl.softmax_dropout(logits, kvmask, seed, causal,
                                           float(dropout_rate), out_dtype)


softmax_dropout.launches = 0


def hybrid_attention(
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
    """Short-sequence attention on [B, S, H, D]: plain batched products
    around ``softmax_dropout``. As in tpudl, the logits are the product
    in the inputs' dtype times the scale in that dtype (bf16 on the
    training path), and the probabilities come out in ``v``'s dtype. The
    products are written as ``matmul`` over [B, H, S, D] views so that
    the logits are contiguous for the kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # The scale rounded to the inputs' dtype, as jnp.asarray(scale, q.dtype).
    scale = float(torch.tensor(scale, dtype=q.dtype))
    logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale
    probs = softmax_dropout(logits, mask=mask, causal=causal,
                            dropout_rate=dropout_rate,
                            dropout_rng=dropout_rng, out_dtype=v.dtype,
                            impl=impl)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)
