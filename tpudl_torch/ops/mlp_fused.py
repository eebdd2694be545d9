"""Fused SwiGLU: the Hopper kernel and its plain version.

The port's counterpart of tpudl.ops.mlp_fused, SwiGLU forward only
(``bias_gelu`` and the backward kernels wait for the training slice).
``swiglu`` keeps the JAX package's signature and ``impl`` seam; the
kernel is ``csrc/mlp_fused.cu`` (it replaces ``_sw_fwd_kernel``),
``swiglu_ref`` is the plain PyTorch version beside it. Dispatch follows
tpudl_torch.ops.norms.resolve_impl: the kernel on CUDA tensors, the
plain version on CPU tensors, no fallback.

``swiglu.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import KERNEL_DTYPES, check_cuda_operand, resolve_impl


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
