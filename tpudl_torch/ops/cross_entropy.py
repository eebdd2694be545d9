"""Fused softmax cross-entropy over integer labels (online logsumexp):
the Hopper kernels, their plain version and the autograd wrapper.

The port's counterpart of tpudl.ops.cross_entropy. The kernels stream
the vocabulary axis once, keeping per row a running max, a running
sum-exp, the label's logit and, under label smoothing, the row sum:

    loss_b = lse_b - (1 - s) * z_b[t_b] - (s / V) * sum_j z_b[j]

The [B, V] probabilities never exist outside the kernels: the forward
saves only ``lse`` [B], and the backward writes ``g_b * (softmax(z)_bj -
q_bj)`` straight into dz (q the (1 - s)-smoothed one-hot plus s / V). No
other [B, V] tensor is allocated. Columns at or past V are never read, so
V needs no padding on the card; tpudl's vocab-block tuning knob has no
counterpart here.

The kernels are ``csrc/cross_entropy.cu``: ``tpudl_xent_fwd`` replaces
``_xent_fwd_kernel`` and ``tpudl_xent_bwd`` replaces ``_xent_bwd_kernel``.
``softmax_cross_entropy_ref`` is the plain version: the composite the
train step always used (optax's, computed in f32). Dispatch follows
tpudl_torch.ops.norms.resolve_impl: the kernel on CUDA tensors, the plain
version on CPU tensors, no fallback.

``softmax_cross_entropy.launches`` and ``xent_bwd.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import (
    KERNEL_DTYPES,
    check_cuda_operand,
    needs_grad,
    resolve_impl,
)


def softmax_cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example cross-entropy ``[...]`` f32 of ``logits [..., V]``:
    the optax composite tpudl's ``impl="reference"`` computes
    (``softmax_cross_entropy_with_integer_labels``, or under smoothing
    ``softmax_cross_entropy`` against ``optax.smooth_labels``), in f32."""
    logits = logits.float()
    labels = labels.long()
    if label_smoothing > 0.0:
        n = logits.shape[-1]
        targets = F.one_hot(labels, n).float()
        targets = targets * (1.0 - label_smoothing) + label_smoothing / n
        return -(targets * torch.log_softmax(logits, -1)).sum(-1)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1),
                           reduction="none").reshape(labels.shape)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("cross_entropy")
        p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_float)
        lib.tpudl_xent_fwd.argtypes = [p, p, p, p, i64, i64, f32, f32, i32,
                                       i32, p]
        lib.tpudl_xent_fwd.restype = i32
        lib.tpudl_xent_bwd.argtypes = [p, p, p, p, p, i64, i64, f32, f32,
                                       i32, p]
        lib.tpudl_xent_bwd.restype = i32
        _lib = lib
    return _lib


def _check(logits, labels):
    """Check the [B, V] logits and [B] labels; return the labels as a
    contiguous int64 tensor."""
    if logits.dtype not in KERNEL_DTYPES:
        raise ValueError(f"cross-entropy kernel takes float32 or bfloat16 "
                         f"logits, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("cross-entropy kernel takes contiguous logits")
    device = logits.device
    check_cuda_operand(logits, "logits", device, logits.dtype)
    labels = labels.to(torch.int64).contiguous()
    check_cuda_operand(labels, "labels", device, torch.int64)
    return labels


def _smoothing(label_smoothing, v):
    return 1.0 - label_smoothing, label_smoothing / v


def _xent_fwd_cuda(logits, labels, label_smoothing):
    """Launch the forward kernel: ``(loss, lse)``, f32 [B] each."""
    labels = _check(logits, labels)
    b, v = logits.shape
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty(b, dtype=torch.float32, device=logits.device)
    if b and v:
        lib = _kernel()
        code = lib.tpudl_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), b, v, *_smoothing(label_smoothing, v),
            int(label_smoothing > 0.0), KERNEL_DTYPES[logits.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _build.check(lib, "xent_fwd", code)
        softmax_cross_entropy.launches += 1
    return loss, lse


def _xent_bwd_cuda(logits, labels, lse, g, label_smoothing):
    """Launch the backward kernel: dz [B, V] in the logits' dtype."""
    labels = _check(logits, labels)
    b, v = logits.shape
    # Autograd hands over the per-row gradient with any strides.
    g = g.to(torch.float32).contiguous()
    for name, t in (("lse", lse), ("g", g)):
        check_cuda_operand(t, name, logits.device, torch.float32)
        if t.shape != (b,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{b}] f32 tensor")
    dz = torch.empty_like(logits)
    if b and v:
        lib = _kernel()
        code = lib.tpudl_xent_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dz.data_ptr(), b, v,
            *_smoothing(label_smoothing, v), KERNEL_DTYPES[logits.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
        _build.check(lib, "xent_bwd", code)
        xent_bwd.launches += 1
    return dz


def xent_bwd_ref(logits, labels, lse, g, label_smoothing: float = 0.0):
    """Plain version of the backward kernel over ``[B, V]`` logits: from
    the forward's ``lse`` and the per-row gradient ``g`` (both f32 [B]),
    ``dz = g * (exp(z - lse) - q)`` in the logits' dtype."""
    v = logits.shape[-1]
    p = torch.exp(logits.float() - lse[:, None])
    q = F.one_hot(labels.long(), v).float() * (1.0 - label_smoothing)
    q = q + label_smoothing / v
    return (g.float()[:, None] * (p - q)).to(logits.dtype)


def xent_bwd(logits, labels, lse, g, label_smoothing: float = 0.0, *,
             impl: str = "auto"):
    """The backward of ``softmax_cross_entropy`` over ``[B, V]`` logits:
    the kernel on CUDA tensors, ``xent_bwd_ref`` on CPU tensors."""
    if not resolve_impl(impl, logits.device):
        return xent_bwd_ref(logits, labels, lse, g, label_smoothing)
    return _xent_bwd_cuda(logits, labels, lse, g, label_smoothing)


xent_bwd.launches = 0


class _FusedXent(torch.autograd.Function):
    """tpudl's ``_xent`` custom_vjp: the forward kernel saves the logits,
    the labels and ``lse`` [B]; the backward kernel writes dz tile by
    tile from them."""

    @staticmethod
    def forward(ctx, logits, labels, label_smoothing):
        loss, lse = _xent_fwd_cuda(logits, labels, label_smoothing)
        ctx.label_smoothing = label_smoothing
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        dz = _xent_bwd_cuda(logits, labels, lse, g, ctx.label_smoothing)
        return dz, None, None


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Per-example softmax cross-entropy over integer labels: ``logits``
    [..., V], ``labels`` [...] int; returns [...] f32. Leading dims are
    rank-generic, as in the optax composite, so an LM-shaped [B, S, V]
    call works on both paths.

    On the kernel path the vocabulary is streamed once (online
    logsumexp), and the [B, V] softmax is never materialised; see the
    module docstring. ``impl``: see tpudl_torch.ops.norms."""
    if logits.dim() < 2 or tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(
            f"expected logits [..., V] and labels [...], got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}"
        )
    if not resolve_impl(impl, logits.device):
        return softmax_cross_entropy_ref(logits, labels, label_smoothing)
    lead = labels.shape
    logits2 = logits.reshape(-1, logits.shape[-1])
    labels1 = labels.reshape(-1)
    s = float(label_smoothing)
    if needs_grad(logits):
        out = _FusedXent.apply(logits2, labels1, s)
    else:
        out, _ = _xent_fwd_cuda(logits2, labels1, s)
    return out.reshape(lead)


softmax_cross_entropy.launches = 0
