"""Fused LayerNorm / RMSNorm (+residual add): the Hopper kernels, their
plain versions, and the autograd wrappers.

The port's counterpart of tpudl.ops.norms. ``layer_norm`` and
``rms_norm`` keep the JAX package's signatures and ``impl`` seam; the
kernels are ``csrc/norms.cu`` (``tpudl_norm_fwd`` replaces
``_norm_fwd_kernel``, ``tpudl_norm_bwd`` replaces ``_norm_bwd_kernel``),
``layer_norm_ref``, ``rms_norm_ref`` and ``norm_bwd_ref`` are the plain
PyTorch versions beside them.

Dispatch is by the tensor's device:

- ``"reference"`` — the plain version, on any device;
- ``"auto"`` / ``"fused"`` on a CUDA tensor — the kernel. Anything the
  kernel does not take raises; nothing falls back to the plain version;
- ``"auto"`` on a CPU tensor — the plain version (the CPU test path);
  ``"fused"`` on a CPU tensor raises.

The forward kernel is the op ``tpudl::layer_norm`` / ``tpudl::rms_norm``
(tpudl_torch.ops.library), whose CPU implementation is the plain
version: without autograd, "auto" reaches the op on either device, so a
``torch.export`` trace holds the op and the artifact dispatches by
device.

Under autograd (grad mode on and an operand that requires grad) the
kernel path runs through ``_FusedNorm``, a ``torch.autograd.Function``
whose forward also writes the per-row f32 statistics (mean and rstd, as
tpudl's ``_ln_fwd`` / ``_rms_fwd`` save them) and whose backward is the
``norm_bwd`` kernel; the residual's gradient is dx itself. Without
autograd (serving runs under ``torch.no_grad``) the forward skips the
statistics.

The forward kernel is a programmatic dependent launch
(``csrc/common.cuh`` ``launch_pdl``): it may start while the kernel
before it on the stream finishes, and reads nothing before that kernel's
writes are visible. A launch the CUDA runtime refuses raises.

``layer_norm.launches``, ``rms_norm.launches`` and ``norm_bwd.launches``
count kernel launches (plain ints; reset them to 0 before a run to see
which path the run took).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpudl_torch.ops import _build

#: The kernels' element-type codes (csrc/common.cuh ``tpudl::DType``).
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: csrc/norms.cu ``Kind``.
_KINDS = {"rms": 0, "layer": 1}
#: The H100's streaming multiprocessors.
_SMS = 132
#: csrc/norms.cu ``BwdRoute``: the backward's three kernels.
BWD_ROUTES = {"scalar": 0, "rows": 1, "wide": 2}
#: The backward's launch policy lives here alone (``bwd_plan``);
#: csrc/norms.cu takes the whole plan and only checks that it fits its
#: kernels, whose sizes these must match (tests/test_torch_norms.py reads
#: them from the source): the rows route's block of ``kBwdRowWarps``
#: warps and rows of at most ``kBwdRowsMaxH`` values, the wide route's
#: ``kBwdWideThreads`` threads, the scalar route's ``kBwdScalarThreads``.
BWD_ROW_WARPS = 4
BWD_ROWS_MAX_H = 1024
BWD_WIDE_THREADS = 256
BWD_SCALAR_THREADS = 512
#: The rows route takes at most 192 16-byte vectors (6 a lane: BERT's
#: 1024 in bf16, 768 in f32; wider f32 rows spilled registers).
BWD_ROWS_MAX_VECTORS = 192
#: Blocks a multiprocessor of each route's grid; the wide route's blocks
#: take 3 a multiprocessor with one vector a thread ("wide1"), else 2.
BWD_BLOCKS_PER_SM = {"rows": 2, "wide1": 3, "wide": 2, "scalar": 8}


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


def needs_grad(*tensors) -> bool:
    """Whether autograd will record an op on these operands."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def layer_norm_ref(x, scale, bias, residual=None, *, eps=1e-12):
    """Plain LayerNorm(+residual): tpudl.ops.norms.layer_norm_ref verbatim
    — native-dtype residual add, f32 one-pass statistics with the
    variance clamped at 0, scale folded into the rsqrt factor before the
    ``(x - mean)`` multiply (flax ``nn.LayerNorm`` bitwise), cast back to
    the input dtype."""
    s = x if residual is None else x + residual
    x32 = s.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = ((x32 - mean) * mul + bias.float()).to(x.dtype)
    return y if residual is None else (y, s)


def rms_norm_ref(x, scale, residual=None, *, eps=1e-5):
    """Plain RMSNorm(+residual): tpudl.ops.norms.rms_norm_ref verbatim —
    native-dtype residual add, f32 mean-square, ``(norm * scale)`` in
    f32, cast back to the input dtype."""
    s = x if residual is None else x + residual
    x32 = s.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    y = (norm * scale).to(x.dtype)
    return y if residual is None else (y, s)


def norm_stats_ref(x, residual=None, *, kind: str, eps: float):
    """The per-row statistics the forward saves for the backward, plain:
    ``(mean, rstd)`` as f32 ``[N]`` over the rows of ``x`` (+
    ``residual``) flattened to ``[N, H]``, the sum taken in f32 as the
    kernels take it; ``mean`` is None for RMSNorm."""
    s = x.float() if residual is None else x.float() + residual.float()
    s = s.reshape(-1, s.shape[-1])
    sumsq = (s * s).mean(-1)
    if kind == "rms":
        return None, torch.rsqrt(sumsq + eps)
    mean = s.mean(-1)
    return mean, torch.rsqrt((sumsq - mean * mean).clamp_min(0.0) + eps)


def norm_bwd_ref(x, scale, residual, mean, rstd, g, gs=None, *, kind: str):
    """Plain version of the backward kernel (tpudl.ops.norms
    ``_norm_bwd_kernel``): from the forward's inputs ``x`` (+
    ``residual``), ``[H]`` ``scale``, the saved f32 statistics ``mean``
    (LayerNorm; None for RMSNorm) and ``rstd`` (``[N]``, one per row of
    the inputs flattened to ``[N, H]``), the gradient ``g`` of the
    normed output and, optionally, ``gs`` of the summed output. Returns
    ``(dx, dscale, dbias)``: the closed-form dx in ``x``'s dtype (also
    the residual's gradient), and dscale, dbias (None for RMSNorm)
    summed over rows in f32."""
    shape, h = x.shape, x.shape[-1]
    s = x.float() if residual is None else x.float() + residual.float()
    s = s.reshape(-1, h)
    g32 = g.float().reshape(-1, h)
    rstd = rstd.reshape(-1, 1)
    if kind == "layer":
        xhat = (s - mean.reshape(-1, 1)) * rstd
    else:
        xhat = s * rstd
    dxhat = g32 * scale.float()
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / h
    if kind == "layer":
        m1 = dxhat.sum(-1, keepdim=True) / h
        ds = rstd * (dxhat - m1 - xhat * m2)
    else:
        ds = rstd * (dxhat - xhat * m2)
    if gs is not None:
        ds = ds + gs.float().reshape(-1, h)
    dscale = (g32 * xhat).sum(0)
    dbias = g32.sum(0) if kind == "layer" else None
    return ds.to(x.dtype).reshape(shape), dscale, dbias


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_lib = None


def bwd_plan(n: int, h: int, itemsize: int, aligned: bool) -> dict:
    """The backward kernel's launch plan for ``n`` rows of ``h`` values of
    ``itemsize`` bytes (``aligned``: every row start, the gradients, dx
    and the scale on 16-byte boundaries): a pure function of these four,
    so the partial sums' order, and the result's bits, depend on the
    shape alone.

    - "rows" (whole 16-byte vectors, ``h`` <= 1024 in at most 192 of
      them): a warp a row, ``vpl`` vectors a lane; ``rows`` rows a warp,
      ``BWD_ROW_WARPS`` warps a block, at most 2 x 132 blocks, each
      walking a contiguous stripe;
    - "wide" (whole vectors, wider rows): a block a row of ``threads``
      threads (at most ``BWD_WIDE_THREADS``) with the fewest vectors a
      thread (``vpl``: 1, 2, 4 or 8); ``rows`` rows a block, 3 x 132
      blocks at one vector a thread, else 2 x 132;
    - "scalar" (anything else): a block of ``threads`` threads (at most
      ``BWD_SCALAR_THREADS``) on ``rows`` rows, ``vpl`` (1, 2, 4 or 8)
      values a thread, at most 8 x 132 blocks.

    ``parts`` is the grid's blocks, each writing one f32 partial row per
    array (dscale, and dbias for LayerNorm) to the workspace. Rows wider
    than the routes take (2048 vectors, or 4096 values unaligned) raise
    ValueError."""
    if n <= 0:
        raise ValueError(f"bwd_plan needs rows, got n={n}")
    vector = aligned and (h * itemsize) % 16 == 0
    nvec = h * itemsize // 16
    if (vector and h <= BWD_ROWS_MAX_H and nvec <= BWD_ROWS_MAX_VECTORS):
        route, per_block = "rows", BWD_ROW_WARPS
        threads, vpl = 32 * BWD_ROW_WARPS, -(-nvec // 32)
        vpl += vpl == 5  # the kernel's lanes hold 1-4 or 6 vectors
        blocks = BWD_BLOCKS_PER_SM["rows"] * _SMS
    else:
        route, per_block = ("wide", 1) if vector else ("scalar", 1)
        units, cap = ((nvec, BWD_WIDE_THREADS) if vector
                      else (h, BWD_SCALAR_THREADS))
        vpl = 1
        while vpl < 8 and -(-units // vpl) > cap:
            vpl *= 2
        per_thread = -(-units // vpl)
        threads = -(-per_thread // 32) * 32
        if threads > cap:
            raise ValueError(f"norm_bwd kernel takes rows of at most "
                             f"{8 * cap} {'vectors' if vector else 'values'}"
                             f", got h={h}")
        key = "scalar" if not vector else "wide1" if vpl == 1 else "wide"
        blocks = BWD_BLOCKS_PER_SM[key] * _SMS
    rows = -(-n // (blocks * per_block))
    parts = -(-n // (rows * per_block))
    return {"route": route, "parts": parts, "rows": rows,
            "rows_per_block": rows * per_block, "threads": threads,
            "vpl": vpl}


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("norms")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.tpudl_norm_fwd.argtypes = [
            i32, p, p, p, p, p, p, p, p,
            i64, i32, i64, i64, ctypes.c_float, i32, p,
        ]
        lib.tpudl_norm_fwd.restype = i32
        lib.tpudl_norm_bwd.argtypes = [
            i32, p, p, p, p, p, p, p, p, p, p,
            i64, i32, i64, i64, i32, i32, i32, i32, i32, i32, p,
        ]
        lib.tpudl_norm_bwd.restype = i32
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rows(x, residual, scale, bias, op):
    """Check the forward's operands; return ``x``, ``residual`` as
    ``[N, H]`` views."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{op} kernel takes float32 or bfloat16, got {x.dtype}")
    device, h = x.device, x.shape[-1]
    check_cuda_operand(x, "x", device, x.dtype)
    for name, p in (("scale", scale), ("bias", bias)):
        if p is not None:
            check_cuda_operand(p, name, device, torch.float32)
            if p.shape != (h,):
                raise ValueError(f"{name} shape {tuple(p.shape)} != ({h},)")
    r2 = None
    if residual is not None:
        check_cuda_operand(residual, "residual", device, x.dtype)
        if residual.shape != x.shape:
            raise ValueError(
                f"residual shape {tuple(residual.shape)} != x shape "
                f"{tuple(x.shape)}"
            )
        r2 = residual.view(-1, h)
    return x.view(-1, h), r2


def _norm_fwd_cuda(kind, x, scale, bias, residual, eps, emit_sum, stats):
    """Launch the forward kernel: ``(y, s, mean, rstd)``, with ``s`` None
    unless a residual is given and ``emit_sum``, and the statistics
    (``[N]`` f32) None unless ``stats`` (``mean`` always None for
    RMSNorm)."""
    op = "layer_norm" if kind == "layer" else "rms_norm"
    x2, r2 = _check_rows(x, residual, scale, bias, op)
    device = x.device
    n, h = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=device)
    s = (torch.empty(x.shape, dtype=x.dtype, device=device)
         if residual is not None and emit_sum else None)
    mean = (torch.empty(n, dtype=torch.float32, device=device)
            if stats and kind == "layer" else None)
    rstd = torch.empty(n, dtype=torch.float32, device=device) if stats else None
    if n and h:
        lib = _kernel()
        code = lib.tpudl_norm_fwd(
            _KINDS[kind], x2.data_ptr(), _ptr(r2), scale.data_ptr(),
            _ptr(bias), y.data_ptr(), _ptr(s), _ptr(mean), _ptr(rstd),
            n, h, x2.stride(0), r2.stride(0) if r2 is not None else 0,
            float(eps), KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(lib, f"{op}_fwd", code)
        (layer_norm if kind == "layer" else rms_norm).launches += 1
    return y, s, mean, rstd


def _norm_bwd_cuda(kind, x, scale, residual, mean, rstd, g, gs,
                   params=True):
    """Launch the backward kernel: ``(dx, dscale, dbias)``, with ``dbias``
    None for RMSNorm and both sums None (and not computed) unless
    ``params``."""
    x2, r2 = _check_rows(x, residual, scale, None, "norm_bwd")
    device = x.device
    n, h = x2.shape
    grads = []
    for name, t in (("g", g), ("gs", gs)):
        if t is None:
            grads.append(None)
            continue
        if t.shape != x.shape:
            raise ValueError(
                f"{name} shape {tuple(t.shape)} != x shape {tuple(x.shape)}"
            )
        # Autograd may hand over a gradient with any strides.
        t = t.contiguous()
        check_cuda_operand(t, name, device, x.dtype)
        grads.append(t.view(-1, h))
    g2, gs2 = grads
    for name, st in (("mean", mean), ("rstd", rstd)):
        if st is None:
            if name == "rstd" or kind == "layer":
                raise ValueError(f"norm_bwd ({kind}) needs the saved {name}")
            continue
        check_cuda_operand(st, name, device, torch.float32)
        if st.shape != (n,) or not st.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] tensor")
    dx = torch.empty(x.shape, dtype=x.dtype, device=device)
    arrays = 2 if kind == "layer" else 1
    dparams = (torch.empty(arrays, h, dtype=torch.float32, device=device)
               if params else None)
    if n and h:
        aligned = all(t is None or t.data_ptr() % 16 == 0
                      for t in (x2, r2, g2, gs2, dx, scale))
        aligned = aligned and all(
            (t.stride(0) * t.element_size()) % 16 == 0
            for t in (x2, r2) if t is not None)
        plan = bwd_plan(n, h, x.element_size(), aligned)
        ws = (torch.empty(arrays * plan["parts"] * h, dtype=torch.float32,
                          device=device) if params else None)
        lib = _kernel()
        code = lib.tpudl_norm_bwd(
            _KINDS[kind], x2.data_ptr(), _ptr(r2), scale.data_ptr(),
            g2.data_ptr(), _ptr(gs2), _ptr(mean), rstd.data_ptr(),
            dx.data_ptr(), _ptr(dparams), _ptr(ws),
            n, h, x2.stride(0), r2.stride(0) if r2 is not None else 0,
            BWD_ROUTES[plan["route"]], plan["parts"], plan["rows"],
            plan["threads"], plan["vpl"],
            KERNEL_DTYPES[x.dtype],
            torch.cuda.current_stream(device).cuda_stream,
        )
        _build.check(lib, "norm_bwd", code)
        norm_bwd.launches += 1
    elif params:
        dparams.zero_()
    if not params:
        return dx, None, None
    return dx, dparams[0], dparams[1] if kind == "layer" else None


def norm_bwd(x, scale, residual, mean, rstd, g, gs=None, *, kind: str,
             impl: str = "auto"):
    """The backward of ``layer_norm`` / ``rms_norm`` (``kind`` "layer" or
    "rms") from the forward's inputs and saved statistics — the kernel
    on CUDA tensors, ``norm_bwd_ref`` on CPU tensors. Arguments and
    result as ``norm_bwd_ref``; the kernel takes ``g`` and ``gs`` with
    any strides (it copies them to contiguous rows)."""
    if kind not in _KINDS:
        raise ValueError(f"kind must be 'layer' or 'rms', got {kind!r}")
    if not resolve_impl(impl, x.device):
        return norm_bwd_ref(x, scale, residual, mean, rstd, g, gs, kind=kind)
    return _norm_bwd_cuda(kind, x, scale, residual, mean, rstd, g, gs)


norm_bwd.launches = 0


class _FusedNorm(torch.autograd.Function):
    """The four forms of tpudl's custom_vjp wrappers (``_ln``,
    ``_ln_res``, ``_rms``, ``_rms_res``) in one Function: the forward
    kernel saves the f32 row statistics, the backward kernel recomputes
    x-hat from the saved inputs. The residual's gradient is dx itself,
    as in ``_ln_res_bwd``."""

    @staticmethod
    def forward(ctx, kind, x, scale, bias, residual, eps, emit_sum):
        y, s, mean, rstd = _op().norm_fwd(kind, x, scale, bias, residual,
                                          eps, emit_sum, True)
        ctx.kind = kind
        ctx.has_bias = bias is not None
        ctx.has_res = residual is not None
        ctx.save_for_backward(x, scale, residual, mean, rstd)
        ctx.set_materialize_grads(False)
        return (y, s) if s is not None else y

    @staticmethod
    def backward(ctx, gy, gs=None):
        x, scale, residual, mean, rstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        # Frozen scales (the Llama LoRA path) skip the column sums.
        params = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dx, dscale, dbias = _norm_bwd_cuda(ctx.kind, x, scale, residual,
                                           mean, rstd, gy, gs, params)
        return (None, dx, dscale, dbias if ctx.has_bias else None,
                dx if ctx.has_res else None, None, None)


def _op():
    """tpudl_torch.ops.library (imported at call time: it imports this
    module)."""
    from tpudl_torch.ops import library

    return library


def takes_op(impl: str, device: torch.device, *operands) -> bool:
    """Whether a wrapper goes through its ``tpudl::`` op
    (tpudl_torch.ops.library) rather than calling the plain version
    itself: ``impl`` "auto" or "fused" (``resolve_impl`` raises for
    "fused" off the card), and on a CPU tensor only where autograd
    records nothing (the op has no CPU backward)."""
    if not resolve_impl(impl, device):
        return impl != "reference" and not needs_grad(*operands)
    return True


def _norm_op(kind, x, scale, bias, residual, eps, return_sum):
    emit_sum = residual is not None and return_sum
    if x.device.type == "cuda" and needs_grad(x, scale, bias, residual):
        return _FusedNorm.apply(kind, x, scale, bias, residual, eps, emit_sum)
    y, s, _, _ = _op().norm_fwd(kind, x, scale, bias, residual, eps,
                                emit_sum, False)
    return (y, s) if emit_sum else y


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-12,
    return_sum: bool = True,
    impl: str = "auto",
):
    """LayerNorm(+residual add) over the last axis of ``x`` — BERT's norm
    (25 calls per BERT-base forward: the embeddings' and two per layer).

    Returns the normed tensor (``x``'s dtype), or ``(normed, x +
    residual)`` when ``residual`` is given; ``return_sum=False`` returns
    only the normed tensor and skips the sum write (BERT is post-norm
    and never reads it). ``scale`` and ``bias`` are f32 ``[H]``.
    ``impl``: see the module docstring."""
    if not takes_op(impl, x.device, x, scale, bias, residual):
        out = layer_norm_ref(x, scale, bias, residual, eps=eps)
        if residual is not None and not return_sum:
            return out[0]
        return out
    return _norm_op("layer", x, scale, bias, residual, eps, return_sum)


layer_norm.launches = 0


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
    if not takes_op(impl, x.device, x, scale, residual):
        out = rms_norm_ref(x, scale, residual, eps=eps)
        if residual is not None and not return_sum:
            return out[0]
        return out
    return _norm_op("rms", x, scale, None, residual, eps, return_sum)


rms_norm.launches = 0
