"""Fused MLP epilogues: bias+GeLU (exact) and SwiGLU — the Hopper
kernels, their plain versions, and the autograd wrapper.

The port's counterpart of tpudl.ops.mlp_fused. ``bias_gelu`` and
``swiglu`` keep the JAX package's signatures and ``impl`` seam; the
kernels are in ``csrc/mlp_fused.cu`` (``tpudl_bias_gelu_fwd`` /
``tpudl_bias_gelu_bwd`` replace ``_bg_fwd_kernel`` / ``_bg_bwd_kernel``,
``tpudl_swiglu_fwd`` replaces ``_sw_fwd_kernel``); ``bias_gelu_ref``,
``bias_gelu_bwd_ref`` and ``swiglu_ref`` are the plain PyTorch versions
beside them. Dispatch follows tpudl_torch.ops.norms.resolve_impl: the
kernel on CUDA tensors, the plain version on CPU tensors, no fallback.

Under autograd the bias+GeLU kernel runs through ``_FusedBiasGelu``,
whose forward saves only ``x`` and ``bias`` (the backward is closed-form
in ``u = x + bias``, no forward recompute) and whose backward is the
``bias_gelu_bwd`` kernel, with the dbias column sum folded in.

``swiglu.launches``, ``bias_gelu.launches`` and
``bias_gelu_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import (
    KERNEL_DTYPES,
    check_cuda_operand,
    needs_grad,
    resolve_impl,
)

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
#: Blocks of the bias+GeLU backward's first pass: about one wave of
#: 8 blocks of 128 threads per SM.
_BG_BWD_BLOCKS = 132 * 8


def swiglu_ref(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain ``silu(gate) * up`` — tpudl.ops.mlp_fused.swiglu_ref, with
    silu spelled ``x * sigmoid(x)`` as jax.nn.silu defines it, in the
    inputs' dtype."""
    return gate * torch.sigmoid(gate) * up


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("mlp_fused")
        lib.tpudl_swiglu_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tpudl_swiglu_fwd.restype = ctypes.c_int
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.tpudl_bias_gelu_fwd.argtypes = [p, p, p, i64, i32, i32, p]
        lib.tpudl_bias_gelu_fwd.restype = i32
        lib.tpudl_bias_gelu_bwd.argtypes = [
            p, p, p, p, p, p, i64, i32, i32, i32, p,
        ]
        lib.tpudl_bias_gelu_bwd.restype = i32
        _lib = lib
    return _lib


def _swiglu_cuda(gate, up):
    if gate.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"swiglu kernel takes float32 or bfloat16, got {gate.dtype}"
        )
    device = gate.device
    check_cuda_operand(gate, "gate", device, gate.dtype)
    check_cuda_operand(up, "up", device, gate.dtype)
    if up.shape != gate.shape:
        raise ValueError(
            f"up shape {tuple(up.shape)} != gate shape {tuple(gate.shape)}"
        )
    if not (gate.is_contiguous() and up.is_contiguous()):
        raise ValueError("swiglu kernel takes contiguous gate and up")
    y = torch.empty_like(gate)
    n = gate.numel()
    if n:
        lib = _kernel()
        code = lib.tpudl_swiglu_fwd(
            gate.data_ptr(), up.data_ptr(), y.data_ptr(), n,
            KERNEL_DTYPES[gate.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(lib, "swiglu_fwd", code)
        swiglu.launches += 1
    return y


def swiglu(
    gate: torch.Tensor,
    up: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """``silu(gate) * up`` (the Llama MLP gate), f32 math, output in the
    inputs' dtype. ``impl``: see tpudl_torch.ops.norms."""
    if not resolve_impl(impl, gate.device):
        return swiglu_ref(gate, up)
    return _swiglu_cuda(gate, up)


swiglu.launches = 0


# ---------------------------------------------------------------------------
# bias + GeLU
# ---------------------------------------------------------------------------


def bias_gelu_ref(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain ``gelu_exact(x + bias)``: tpudl.ops.mlp_fused.bias_gelu_ref —
    the bias added in ``x``'s dtype (the composite Dense's epilogue),
    then the exact (erf) GeLU."""
    return F.gelu(x + bias.to(x.dtype), approximate="none")


def bias_gelu_bwd_ref(x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward kernel (tpudl.ops.mlp_fused
    ``_bg_bwd_kernel``): with ``u = x + bias`` in f32, ``du = g * (Phi(u)
    + u * phi(u))``; returns ``(du in x's dtype, db = du summed over all
    leading axes, in f32)``."""
    u = x.float() + bias.float()
    phi = torch.exp(-0.5 * u * u) * _INV_SQRT_2PI
    du = g.float() * (0.5 * (1.0 + torch.erf(u * _INV_SQRT2)) + u * phi)
    return du.to(x.dtype), du.reshape(-1, du.shape[-1]).sum(0)


def _check_bg(x, bias, op):
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{op} kernel takes float32 or bfloat16, got {x.dtype}")
    device, f = x.device, x.shape[-1]
    check_cuda_operand(x, "x", device, x.dtype)
    check_cuda_operand(bias, "bias", device, torch.float32)
    if bias.shape != (f,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != ({f},)")
    if not x.is_contiguous():
        raise ValueError(f"{op} kernel takes a contiguous x")


def _bias_gelu_cuda(x, bias):
    _check_bg(x, bias, "bias_gelu")
    y = torch.empty_like(x)
    f = x.shape[-1]
    n = x.numel() // f if f else 0
    if n and f:
        lib = _kernel()
        code = lib.tpudl_bias_gelu_fwd(
            x.data_ptr(), bias.data_ptr(), y.data_ptr(), n, f,
            KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(lib, "bias_gelu_fwd", code)
        bias_gelu.launches += 1
    return y


def _bias_gelu_bwd_cuda(x, bias, g):
    _check_bg(x, bias, "bias_gelu_bwd")
    if g.shape != x.shape:
        raise ValueError(f"g shape {tuple(g.shape)} != x shape {tuple(x.shape)}")
    # Autograd may hand over a gradient with any strides.
    g = g.contiguous()
    check_cuda_operand(g, "g", x.device, x.dtype)
    dx = torch.empty_like(x)
    f = x.shape[-1]
    n = x.numel() // f if f else 0
    db = torch.zeros(f, dtype=torch.float32, device=x.device)
    if n and f:
        # Column chunks of one 16-byte vector, 128 per block.
        chunks = -(-f // (16 // x.element_size()))
        blocks_x = -(-chunks // 128)
        rows_per_block = -(-n // min(n, max(1, _BG_BWD_BLOCKS // blocks_x)))
        ws = torch.empty(-(-n // rows_per_block) * f, dtype=torch.float32,
                         device=x.device)
        lib = _kernel()
        code = lib.tpudl_bias_gelu_bwd(
            x.data_ptr(), bias.data_ptr(), g.data_ptr(), dx.data_ptr(),
            db.data_ptr(), ws.data_ptr(), n, f, rows_per_block,
            KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(lib, "bias_gelu_bwd", code)
        bias_gelu_bwd.launches += 1
    return dx, db


def bias_gelu_bwd(x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor, *,
                  impl: str = "auto"):
    """The backward of ``bias_gelu`` — the kernel on CUDA tensors,
    ``bias_gelu_bwd_ref`` on CPU tensors: ``(dx in x's dtype, db f32)``.
    The kernel takes ``g`` with any strides (it copies it to contiguous
    rows)."""
    if not resolve_impl(impl, x.device):
        return bias_gelu_bwd_ref(x, bias, g)
    return _bias_gelu_bwd_cuda(x, bias, g)


bias_gelu_bwd.launches = 0


class _FusedBiasGelu(torch.autograd.Function):
    """tpudl's ``_bg`` custom_vjp: the forward kernel saves ``x`` and
    ``bias`` only; the backward kernel returns dx and the f32 dbias."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return _bias_gelu_cuda(x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx, db = _bias_gelu_bwd_cuda(x, bias, g)
        return dx, db.to(bias.dtype)


def bias_gelu(
    x: torch.Tensor,
    bias: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """``gelu_exact(x + bias)`` over the last axis of ``x`` (``[..., F]``
    with an f32 ``bias [F]``) — the BERT intermediate epilogue (12 calls
    per BERT-base forward); the kernel adds the bias and applies the GeLU
    in f32 and rounds once. ``impl``: see tpudl_torch.ops.norms."""
    if not resolve_impl(impl, x.device):
        return bias_gelu_ref(x, bias)
    if needs_grad(x, bias):
        return _FusedBiasGelu.apply(x, bias)
    return _bias_gelu_cuda(x, bias)


bias_gelu.launches = 0
