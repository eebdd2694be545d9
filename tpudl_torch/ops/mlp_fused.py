"""Fused MLP epilogues: bias+GeLU (exact) and SwiGLU — the Hopper
kernels, their plain versions, and the autograd wrapper.

The port's counterpart of tpudl.ops.mlp_fused. ``bias_gelu`` and
``swiglu`` keep the JAX package's signatures and ``impl`` seam; the
kernels are in ``csrc/mlp_fused.cu`` (``tpudl_bias_gelu_fwd`` /
``tpudl_bias_gelu_bwd`` replace ``_bg_fwd_kernel`` / ``_bg_bwd_kernel``,
``tpudl_swiglu_fwd`` / ``tpudl_swiglu_bwd`` replace ``_sw_fwd_kernel`` /
``_sw_bwd_kernel``); ``bias_gelu_ref``, ``bias_gelu_bwd_ref``,
``swiglu_ref`` and ``swiglu_bwd_ref`` are the plain PyTorch versions
beside them. Dispatch follows tpudl_torch.ops.norms.resolve_impl: the
kernel on CUDA tensors, the plain version on CPU tensors, no fallback.

Under autograd the bias+GeLU kernel runs through ``_FusedBiasGelu``,
whose forward saves only ``x`` and ``bias`` (the backward is closed-form
in ``u = x + bias``, no forward recompute) and whose backward is the
``bias_gelu_bwd`` kernel, with the dbias column sum folded in. The SwiGLU
kernel runs through ``_FusedSwiGLU`` likewise (it saves ``gate`` and
``up``; its backward is the ``swiglu_bwd`` kernel); without autograd
(serving) it is the forward kernel alone.

The SwiGLU forward is a programmatic dependent launch, as the norm
forward is (tpudl_torch.ops.norms).

``swiglu.launches``, ``swiglu_bwd.launches``, ``bias_gelu.launches`` and
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
    takes_op,
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
        lib.tpudl_swiglu_bwd.argtypes = [p, p, p, p, p, i64, i32, p]
        lib.tpudl_swiglu_bwd.restype = i32
        lib.tpudl_bias_gelu_fwd.argtypes = [p, p, p, i64, i32, i32, p]
        lib.tpudl_bias_gelu_fwd.restype = i32
        lib.tpudl_bias_gelu_bwd.argtypes = [
            p, p, p, p, p, p, i64, i32, i32, i32, p,
        ]
        lib.tpudl_bias_gelu_bwd.restype = i32
        _lib = lib
    return _lib


def _check_swiglu(gate, up, op, *others):
    if gate.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"{op} kernel takes float32 or bfloat16, got {gate.dtype}"
        )
    device = gate.device
    for name, t in (("gate", gate), ("up", up), *others):
        check_cuda_operand(t, name, device, gate.dtype)
        if t.shape != gate.shape:
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != gate shape "
                f"{tuple(gate.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{op} kernel takes contiguous gate and up")


def _swiglu_cuda(gate, up):
    _check_swiglu(gate, up, "swiglu")
    y = torch.empty_like(gate)
    n = gate.numel()
    if n:
        lib = _kernel()
        code = lib.tpudl_swiglu_fwd(
            gate.data_ptr(), up.data_ptr(), y.data_ptr(), n,
            KERNEL_DTYPES[gate.dtype],
            torch.cuda.current_stream(gate.device).cuda_stream,
        )
        _build.check(lib, "swiglu_fwd", code)
        swiglu.launches += 1
    return y


def swiglu_bwd_ref(gate: torch.Tensor, up: torch.Tensor, g: torch.Tensor):
    """Plain version of the backward kernel (tpudl.ops.mlp_fused
    ``_sw_bwd_kernel``): in f32, with ``s = sigmoid(gate)`` and ``silu =
    gate * s``, ``dgate = g * up * (s + silu * (1 - s))`` and ``dup = g *
    silu``, each rounded once to its input's dtype."""
    g32, u32, go = gate.float(), up.float(), g.float()
    s = torch.sigmoid(g32)
    silu = g32 * s
    return ((go * u32 * (s + silu * (1.0 - s))).to(gate.dtype),
            (go * silu).to(up.dtype))


def _swiglu_bwd_cuda(gate, up, g):
    # Autograd may hand over a gradient with any strides.
    g = g.contiguous()
    _check_swiglu(gate, up, "swiglu_bwd", ("g", g))
    dgate, dup = torch.empty_like(gate), torch.empty_like(up)
    n = gate.numel()
    if n:
        lib = _kernel()
        code = lib.tpudl_swiglu_bwd(
            gate.data_ptr(), up.data_ptr(), g.data_ptr(), dgate.data_ptr(),
            dup.data_ptr(), n, KERNEL_DTYPES[gate.dtype],
            torch.cuda.current_stream(gate.device).cuda_stream,
        )
        _build.check(lib, "swiglu_bwd", code)
        swiglu_bwd.launches += 1
    return dgate, dup


def swiglu_bwd(gate: torch.Tensor, up: torch.Tensor, g: torch.Tensor, *,
               impl: str = "auto"):
    """The backward of ``swiglu``: ``(dgate, dup)`` — the kernel on CUDA
    tensors, ``swiglu_bwd_ref`` on CPU tensors."""
    if not resolve_impl(impl, gate.device):
        return swiglu_bwd_ref(gate, up, g)
    return _swiglu_bwd_cuda(gate, up, g)


swiglu_bwd.launches = 0


class _FusedSwiGLU(torch.autograd.Function):
    """tpudl's ``_sw`` custom_vjp: the forward kernel saves ``gate`` and
    ``up``; the backward kernel returns their gradients."""

    @staticmethod
    def forward(ctx, gate, up):
        ctx.save_for_backward(gate, up)
        return torch.ops.tpudl.swiglu(gate, up)

    @staticmethod
    def backward(ctx, g):
        gate, up = ctx.saved_tensors
        return _swiglu_bwd_cuda(gate, up, g)


def swiglu(
    gate: torch.Tensor,
    up: torch.Tensor,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """``silu(gate) * up`` (the Llama MLP gate), f32 math, output in the
    inputs' dtype. ``impl``: see tpudl_torch.ops.norms. Under autograd the
    kernel path runs through ``_FusedSwiGLU`` (whose backward is the
    ``swiglu_bwd`` kernel)."""
    if not takes_op(impl, gate.device, gate, up):
        return swiglu_ref(gate, up)
    if gate.device.type == "cuda" and needs_grad(gate, up):
        return _FusedSwiGLU.apply(gate, up)
    return torch.ops.tpudl.swiglu(gate, up)


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
        return torch.ops.tpudl.bias_gelu(x, bias)

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
    if not takes_op(impl, x.device, x, bias):
        return bias_gelu_ref(x, bias)
    if x.device.type == "cuda" and needs_grad(x, bias):
        return _FusedBiasGelu.apply(x, bias)
    return torch.ops.tpudl.bias_gelu(x, bias)


bias_gelu.launches = 0
