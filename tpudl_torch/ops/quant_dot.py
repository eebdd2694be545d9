"""The weight-only quantized product: the Hopper kernel, its plain twin,
and the wrapper that dispatches between them.

``quant_matmul(x, qvalues, qscale)`` is ``y = (x @ qvalues^T) * qscale``
with f32 accumulation, the scale applied once after the contraction and
the result cast to ``x``'s dtype: tpudl's fused quantized product
(tpudl/quant/dense.py ``quant_dot``, impl "fused"), for the port's
``[out, in]`` weights. The full-precision weight never exists.

- the kernel is ``csrc/quant_dot.cu``: ``tpudl_quant_gemv`` for at most
  16 rows of x (decode; a programmatic dependent launch), and
  ``tpudl_quant_gemm`` past that (prefill, BERT). It replaces no Pallas
  kernel: tpudl's product is XLA's mixed-dtype ``dot_general``;
- ``quant_matmul_ref`` is the plain twin: ``x`` and the weights widened
  to f32, one f32 product, the scale, the cast. The CPU tests hold it to
  tpudl; ``chip_smoke.py`` holds the kernel to it. Nothing on the card's
  main path calls it.

``quant_matmul`` is the op ``tpudl::quant_dot`` (tpudl_torch.ops.library):
on a CUDA tensor the kernel (a shape it does not take raises, nothing
falls back), on a CPU tensor the plain twin, so a ``torch.export`` trace
holds it; tpudl_torch.quant.dense.quant_dot holds tpudl's ``impl`` seam
in front of it ("fused" on a CPU tensor raises there). Its gradient with respect to ``x``
(a LoRA adapter trained over a quantized base) is a plain product with
the dequantized weight; the quantized pair takes none.

``quant_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import KERNEL_DTYPES, check_cuda_operand

#: Weight storage dtypes the kernel takes (csrc/quant_dot.cu ``QType``).
QTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
#: Rows of x up to which the GEMV entry point runs.
GEMV_MAX_ROWS = 16
#: The tiled kernel's grid bound on rows (65535 row tiles of 64).
GEMM_MAX_ROWS = 65535 * 64


def quant_matmul_ref(x: torch.Tensor, qvalues: torch.Tensor,
                     qscale: torch.Tensor) -> torch.Tensor:
    """The plain twin of the fused form: ``(x_f32 @ q_f32^T) * scale``,
    cast to ``x``'s dtype."""
    y = torch.matmul(x.float(), qvalues.float().t())
    return (y * qscale).to(x.dtype)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("quant_dot")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for fn in (lib.tpudl_quant_gemv, lib.tpudl_quant_gemm):
            fn.argtypes = [p, p, p, p, i32, i32, i64, i32, i32, p]
            fn.restype = i32
        _lib = lib
    return _lib


def check_operands(x, qvalues, qscale) -> None:
    """Raise unless the kernel takes these operands: x f32 or bf16 on the
    card, qvalues int8 or e4m3 ``[N, K]`` contiguous with K = x's last
    dimension, qscale f32 ``[N]``, and a row count the grid holds."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"quant_dot kernel takes f32 or bf16 x, got {x.dtype}")
    if qvalues.dtype not in QTYPES:
        raise ValueError(f"quant_dot kernel takes int8 or float8_e4m3fn "
                         f"weights, got {qvalues.dtype}")
    if qvalues.dim() != 2 or qvalues.shape[1] != x.shape[-1]:
        raise ValueError(f"qvalues must be [N, K] with K = x's last dimension "
                         f"{x.shape[-1]}, got {tuple(qvalues.shape)}")
    if tuple(qscale.shape) != (qvalues.shape[0],):
        raise ValueError(f"qscale must be [{qvalues.shape[0]}], got "
                         f"{tuple(qscale.shape)}")
    check_cuda_operand(x, "x", x.device, x.dtype)
    check_cuda_operand(qvalues, "qvalues", x.device, qvalues.dtype)
    check_cuda_operand(qscale, "qscale", x.device, torch.float32)
    if not qvalues.is_contiguous():
        raise ValueError("quant_dot kernel takes contiguous qvalues")
    rows = x.numel() // max(x.shape[-1], 1)
    if rows > GEMM_MAX_ROWS:
        raise ValueError(f"quant_dot kernel takes at most {GEMM_MAX_ROWS} "
                         f"rows, got {rows}")
    if x.shape[-1] == 0 or qvalues.shape[0] == 0:
        raise ValueError("quant_dot kernel takes non-empty K and N")


def _quant_dot_cuda(x: torch.Tensor, qvalues: torch.Tensor,
                    qscale: torch.Tensor) -> torch.Tensor:
    check_operands(x, qvalues, qscale)
    n, k = qvalues.shape
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        lib = _kernel()
        fn = lib.tpudl_quant_gemv if m <= GEMV_MAX_ROWS else lib.tpudl_quant_gemm
        code = fn(x2.data_ptr(), qvalues.data_ptr(), qscale.data_ptr(),
                  y.data_ptr(), m, n, k, KERNEL_DTYPES[x.dtype],
                  QTYPES[qvalues.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, "quant_gemv" if m <= GEMV_MAX_ROWS else "quant_gemm",
                     code)
        quant_matmul.launches += 1
    return y.reshape(*x.shape[:-1], n)


def quant_matmul(x: torch.Tensor, qvalues: torch.Tensor,
                 qscale: torch.Tensor) -> torch.Tensor:
    """``(x @ qvalues^T) * qscale`` in ``x``'s dtype, f32 accumulation,
    through the op: the kernel on CUDA tensors, the plain twin on CPU
    tensors (tpudl_torch.quant.dense.quant_dot holds the ``impl``
    seam)."""
    return torch.ops.tpudl.quant_dot(x, qvalues, qscale)


quant_matmul.launches = 0
