"""Fused RMSNorm (+residual add): the Hopper kernel and its plain version.

The port's counterpart of tpudl.ops.norms, forward only (LayerNorm and
the backward kernel wait for the training slice). ``rms_norm`` keeps
the JAX package's signature and ``impl`` seam; the kernel is
``csrc/norms.cu`` (it replaces ``_norm_fwd_kernel``), ``rms_norm_ref``
is the plain PyTorch version beside it.

Dispatch is by the tensor's device:

- ``"reference"`` — the plain version, on any device;
- ``"auto"`` / ``"fused"`` on a CUDA tensor — the kernel. Anything the
  kernel does not take raises; nothing falls back to the plain version;
- ``"auto"`` on a CPU tensor — the plain version (the CPU test path);
  ``"fused"`` on a CPU tensor raises.

``rms_norm.launches`` counts kernel launches (a plain int; reset it to 0
before a run to see which path the run took).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudl_torch.ops import _build

#: The kernels' element-type codes (csrc/common.cuh ``tpudl::DType``).
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_impl(impl: str, device: torch.device) -> bool:
    """The dispatch rule shared by the port's ops: ``impl`` and the
    operand's device -> whether to launch the Hopper kernel."""
    if impl not in ("auto", "fused", "reference"):
        raise ValueError(
            f"impl must be 'auto', 'fused' or 'reference', got {impl!r}"
        )
    if impl == "reference":
        return False
    if device.type == "cuda":
        return True
    if device.type == "cpu" and impl == "auto":
        return False
    raise ValueError(
        f"impl={impl!r} on a {device.type} tensor: the Hopper kernel takes "
        f"CUDA tensors only (impl='auto' or 'reference' runs the plain "
        f"version on the CPU)"
    )


def fused_ops_impl(flag) -> str:
    """Model-config ``fused_ops`` flag -> ops ``impl`` name: False ->
    "reference", True -> "auto" (the kernel on CUDA tensors, the plain
    version on CPU tensors), "force" -> "fused" (the kernel or an
    error)."""
    if not flag:
        return "reference"
    if flag == "force":
        return "fused"
    return "auto"


def check_cuda_operand(t: torch.Tensor, name: str, device: torch.device,
                       dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor on ``device`` whose last
    dimension is contiguous — what every kernel here takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"{name} is on {device} but the current CUDA device is "
            f"cuda:{torch.cuda.current_device()}"
        )


def rms_norm_ref(x, scale, residual=None, *, eps=1e-5):
    """Plain RMSNorm(+residual): tpudl.ops.norms.rms_norm_ref verbatim —
    native-dtype residual add, f32 mean-square, ``(norm * scale)`` in
    f32, cast back to the input dtype."""
    s = x if residual is None else x + residual
    x32 = s.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    y = (norm * scale).to(x.dtype)
    return y if residual is None else (y, s)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("norms")
        lib.tpudl_rms_norm_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tpudl_rms_norm_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _rms_norm_cuda(x, scale, residual, eps, return_sum):
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"rms_norm kernel takes float32 or bfloat16, got {x.dtype}"
        )
    device = x.device
    h = x.shape[-1]
    check_cuda_operand(x, "x", device, x.dtype)
    check_cuda_operand(scale, "scale", device, torch.float32)
    if scale.shape != (h,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({h},)")
    x2 = x.view(-1, h)
    r2 = None
    if residual is not None:
        check_cuda_operand(residual, "residual", device, x.dtype)
        if residual.shape != x.shape:
            raise ValueError(
                f"residual shape {tuple(residual.shape)} != x shape "
                f"{tuple(x.shape)}"
            )
        r2 = residual.view(-1, h)
    n = x2.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=device)
    s = (
        torch.empty(x.shape, dtype=x.dtype, device=device)
        if residual is not None and return_sum
        else None
    )
    if n and h:
        lib = _kernel()
        code = lib.tpudl_rms_norm_fwd(
            x2.data_ptr(),
            r2.data_ptr() if r2 is not None else None,
            scale.data_ptr(),
            y.data_ptr(),
            s.data_ptr() if s is not None else None,
            n, h, x2.stride(0), r2.stride(0) if r2 is not None else 0,
            float(eps), KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(lib, "rms_norm_fwd", code)
        rms_norm.launches += 1
    return (y, s) if s is not None else y


def rms_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
    return_sum: bool = True,
    impl: str = "auto",
):
    """RMSNorm(+residual add) over the last axis of ``x`` — the decode
    path's norm (65 calls per Llama-3-8B prefill or decode step).

    Returns the normed tensor (``x``'s dtype), or ``(normed, x +
    residual)`` when ``residual`` is given; ``return_sum=False`` returns
    only the normed tensor and skips the sum write. ``impl``: see the
    module docstring."""
    if not resolve_impl(impl, x.device):
        out = rms_norm_ref(x, scale, residual, eps=eps)
        if residual is not None and not return_sum:
            return out[0]
        return out
    return _rms_norm_cuda(x, scale, residual, eps, return_sum)


rms_norm.launches = 0
