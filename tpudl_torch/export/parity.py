"""Cross-backend numerical parity: the port's counterpart of
tpudl.export.parity.

The reference checks OpenVINO against ONNX Runtime with
``np.allclose(rtol=1e-05, atol=1e-04)`` (reference
notebooks/cv/onnx_experiments.py:142-144): two backends running one
artifact. Here the two backends are the card and the CPU running one
``torch.export`` program, each copy moved to its device
(``move_to_device_pass``): its ``tpudl::`` ops run the Hopper kernels on
the card and their plain versions on the CPU.

As on the TPU, f32 on the card is not f32 by default: cuBLAS and cuDNN
may round matmul and convolution inputs to TF32. Two modes:

- ``strict=True``: TF32 off for matmuls and for cuDNN (the port's form of
  ``jax.default_matmul_precision("highest")``; both flags are restored
  afterwards), the reference's tolerances (rtol 1e-5, atol 1e-4);
- ``strict=False``: the deployed precision, loose tolerances (rtol 2e-2,
  atol 2e-2).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree

#: f32 tolerances from reference notebooks/cv/onnx_experiments.py:144.
STRICT_RTOL, STRICT_ATOL = 1e-5, 1e-4
#: Deployment (bf16 / TF32) tolerances.
DEPLOY_RTOL, DEPLOY_ATOL = 2e-2, 2e-2


@dataclasses.dataclass
class ParityReport:
    ok: bool
    rtol: float
    atol: float
    backend_a: str
    backend_b: str
    max_abs_err: float
    max_rel_err: float
    num_outputs: int

    def __str__(self):
        status = "PASS" if self.ok else "FAIL"
        return (
            f"parity {status}: {self.backend_a} vs {self.backend_b} "
            f"rtol={self.rtol} atol={self.atol} "
            f"max_abs={self.max_abs_err:.3e} max_rel={self.max_rel_err:.3e}"
        )


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.is_floating_point():
            leaf = leaf.double()
        return leaf.numpy()
    return np.asarray(leaf)


def _leaves(tree) -> list:
    return [leaf for leaf in _pytree.tree_leaves(tree)
            if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic,
                                 int, float, bool))]


def compare_outputs(out_a: Any, out_b: Any, rtol: float, atol: float,
                    backend_a: str = "a", backend_b: str = "b"
                    ) -> ParityReport:
    """Numerically compare two output trees (tensors or arrays) leaf by
    leaf, in float64."""
    leaves_a, leaves_b = _leaves(out_a), _leaves(out_b)
    ok = len(leaves_a) == len(leaves_b)
    max_abs = 0.0
    max_rel = 0.0
    for a, b in zip(leaves_a, leaves_b):
        a64 = np.asarray(_numpy(a), np.float64)
        b64 = np.asarray(_numpy(b), np.float64)
        abs_err = np.abs(a64 - b64)
        max_abs = max(max_abs, float(abs_err.max(initial=0.0)))
        denom = np.abs(b64) + 1e-12
        max_rel = max(max_rel, float((abs_err / denom).max(initial=0.0)))
        if not np.allclose(a64, b64, rtol=rtol, atol=atol):
            ok = False
    return ParityReport(ok=ok, rtol=rtol, atol=atol, backend_a=backend_a,
                        backend_b=backend_b, max_abs_err=max_abs,
                        max_rel_err=max_rel, num_outputs=len(leaves_a))


@contextlib.contextmanager
def highest_precision():
    """TF32 off for matmuls and for cuDNN convolutions, and f32 matmul
    precision "highest"; every flag restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _to(tree, device):
    return _pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, tree)


def _program(fn):
    """``fn`` as an ExportedProgram when it is one or an artifact (bytes or
    a path), else None."""
    if isinstance(fn, torch.export.ExportedProgram):
        return fn
    if isinstance(fn, (bytes, str)):
        from tpudl_torch.export.export import load_exported_obj

        return load_exported_obj(fn)
    return None


def run_on(fn, args: Sequence[Any], device) -> Any:
    """``fn(*args)`` on ``device``, the outputs on the host. An artifact
    (an ExportedProgram, its bytes or its path) is moved to ``device``
    first (``move_to_device_pass``); a plain callable runs on the
    arguments placed there."""
    device = torch.device(device)
    program = _program(fn)
    if program is not None:
        from torch.export.passes import move_to_device_pass

        fn = move_to_device_pass(program, device).module()
    with torch.no_grad():
        out = fn(*_to(tuple(args), device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return _to(out, "cpu")


def check_parity(fn: Callable, args: Sequence[Any], device_a=None,
                 device_b=None, rtol: Optional[float] = None,
                 atol: Optional[float] = None, strict: bool = True
                 ) -> ParityReport:
    """Run ``fn(*args)`` on two devices (default: the card, then the CPU)
    and compare the outputs. ``fn`` is an artifact (an ExportedProgram,
    its bytes or its path; each side loads its own copy) or a callable."""
    if device_a is None:
        device_a = "cuda"
    if device_b is None:
        device_b = "cpu"
    if rtol is None:
        rtol = STRICT_RTOL if strict else DEPLOY_RTOL
    if atol is None:
        atol = STRICT_ATOL if strict else DEPLOY_ATOL
    with highest_precision() if strict else contextlib.nullcontext():
        out_a = run_on(fn, args, device_a)
        out_b = run_on(fn, args, device_b)
    return compare_outputs(out_a, out_b, rtol, atol,
                           backend_a=torch.device(device_a).type,
                           backend_b=torch.device(device_b).type)


def assert_parity(fn, args, **kwargs) -> ParityReport:
    report = check_parity(fn, args, **kwargs)
    if not report.ok:
        raise AssertionError(str(report))
    return report
