"""The forward kernels as ``torch.library`` ops, namespace ``tpudl``.

Every kernel launches through ``ctypes`` on ``data_ptr()``
(tpudl_torch.ops._build), which ``torch.export`` cannot trace: it traces
with fake tensors, which have no memory. Each forward kernel an exported
program reaches is therefore also an op of the dispatcher:

- ``tpudl::rms_norm`` and ``tpudl::layer_norm`` (csrc/norms.cu, the
  forward; replaces tpudl/ops/norms.py:199);
- ``tpudl::swiglu`` and ``tpudl::bias_gelu`` (csrc/mlp_fused.cu;
  tpudl/ops/mlp_fused.py:197 and :94);
- ``tpudl::softmax_dropout`` (csrc/softmax_dropout.cu, the forward;
  tpudl/ops/softmax_dropout.py:168);
- ``tpudl::segmented_lora`` (csrc/segmented_lora.cu;
  tpudl/ops/segmented_lora.py:177);
- ``tpudl::quant_dot`` (csrc/quant_dot.cu, the weight-only int8/e4m3
  product; tpudl's is XLA's mixed-dtype dot in tpudl/quant/dense.py).
  It also has a gradient with respect to x (``register_autograd``).

Each op has three implementations: a fake one (output shapes, for
tracing), a CUDA one that is the wrapper's existing launch (its launch
counter included) and a CPU one that is the plain PyTorch version. An
exported program holds ``tpudl::`` nodes and so dispatches by device:
the kernels on the card, the plain versions on the CPU, from one
artifact. That is the port's form of tpudl's multi-platform StableHLO
(tpudl/export/export.py:45-66).

The wrappers' ``impl`` seam is unchanged: ``"reference"`` never reaches
an op, ``"fused"`` on a CPU tensor raises before it, and ``"auto"`` and
``"fused"`` reach it (the kernel on a CUDA tensor). Under autograd the
wrappers' ``torch.autograd.Function``s call the op in their forward;
a CPU operand that needs a gradient takes the plain version directly.

An optional output the kernel does not write (the residual sum, the row
statistics) comes back as an empty tensor.
"""

from typing import Optional, Tuple

import torch

from tpudl_torch.ops import (
    mlp_fused,
    norms,
    quant_dot,
    segmented_lora,
    softmax_dropout,
)

Tensor = torch.Tensor


def _none(x: Tensor) -> Tensor:
    """The stand-in for an output that was not asked for."""
    return x.new_empty(0)


def _or_none(t: Optional[Tensor], x: Tensor) -> Tensor:
    return _none(x) if t is None else t


# ---------------------------------------------------------------------------
# norms (the forward kernel; the backward stays a ctypes launch)
# ---------------------------------------------------------------------------


def _norm_fake(x, residual, emit_sum, stats, kind):
    rows = x.numel() // x.shape[-1] if x.dim() and x.shape[-1] else 0
    f32 = dict(dtype=torch.float32, device=x.device)
    s = (torch.empty_like(x) if residual is not None and emit_sum
         else _none(x))
    mean = (torch.empty(rows, **f32) if stats and kind == "layer"
            else _none(x))
    rstd = torch.empty(rows, **f32) if stats else _none(x)
    return torch.empty_like(x), s, mean, rstd


def _norm_plain(kind, x, scale, bias, residual, eps, emit_sum, stats):
    if kind == "layer":
        out = norms.layer_norm_ref(x, scale, bias, residual, eps=eps)
    else:
        out = norms.rms_norm_ref(x, scale, residual, eps=eps)
    y, s = (out, None) if residual is None else out
    mean = rstd = None
    if stats:
        mean, rstd = norms.norm_stats_ref(x, residual, kind=kind, eps=eps)
    return (y, _or_none(s if emit_sum else None, x), _or_none(mean, x),
            _or_none(rstd, x))


def _norm_kernel(kind, x, scale, bias, residual, eps, emit_sum, stats):
    y, s, mean, rstd = norms._norm_fwd_cuda(kind, x, scale, bias, residual,
                                            eps, emit_sum, stats)
    return y, _or_none(s, x), _or_none(mean, x), _or_none(rstd, x)


@torch.library.custom_op("tpudl::rms_norm", mutates_args=())
def rms_norm(x: Tensor, scale: Tensor, residual: Optional[Tensor],
             eps: float, emit_sum: bool, stats: bool
             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(y, x + residual, mean, rstd)``; the sum only with a residual
    and ``emit_sum``, ``rstd`` only with ``stats``, ``mean`` never."""
    return _norm_plain("rms", x, scale, None, residual, eps, emit_sum, stats)


@rms_norm.register_fake
def _(x, scale, residual, eps, emit_sum, stats):
    return _norm_fake(x, residual, emit_sum, stats, "rms")


@rms_norm.register_kernel("cuda")
def _(x, scale, residual, eps, emit_sum, stats):
    return _norm_kernel("rms", x, scale, None, residual, eps, emit_sum, stats)


@torch.library.custom_op("tpudl::layer_norm", mutates_args=())
def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               residual: Optional[Tensor], eps: float, emit_sum: bool,
               stats: bool) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(y, x + residual, mean, rstd)``, as ``tpudl::rms_norm``, with
    ``mean`` too when ``stats``."""
    return _norm_plain("layer", x, scale, bias, residual, eps, emit_sum,
                       stats)


@layer_norm.register_fake
def _(x, scale, bias, residual, eps, emit_sum, stats):
    return _norm_fake(x, residual, emit_sum, stats, "layer")


@layer_norm.register_kernel("cuda")
def _(x, scale, bias, residual, eps, emit_sum, stats):
    return _norm_kernel("layer", x, scale, bias, residual, eps, emit_sum,
                        stats)


def norm_fwd(kind, x, scale, bias, residual, eps, emit_sum, stats):
    """The norm op of ``kind`` with the outputs not asked for as None:
    ``(y, s, mean, rstd)`` like ``norms._norm_fwd_cuda``."""
    if kind == "layer":
        out = layer_norm(x, scale, bias, residual, eps, emit_sum, stats)
    else:
        out = rms_norm(x, scale, residual, eps, emit_sum, stats)
    y, s, mean, rstd = out
    return (y, s if residual is not None and emit_sum else None,
            mean if stats and kind == "layer" else None,
            rstd if stats else None)


# ---------------------------------------------------------------------------
# SwiGLU, bias + GeLU
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpudl::swiglu", mutates_args=())
def swiglu(gate: Tensor, up: Tensor) -> Tensor:
    return mlp_fused.swiglu_ref(gate, up)


@swiglu.register_fake
def _(gate, up):
    return torch.empty_like(gate)


@swiglu.register_kernel("cuda")
def _(gate, up):
    return mlp_fused._swiglu_cuda(gate, up)


@torch.library.custom_op("tpudl::bias_gelu", mutates_args=())
def bias_gelu(x: Tensor, bias: Tensor) -> Tensor:
    return mlp_fused.bias_gelu_ref(x, bias)


@bias_gelu.register_fake
def _(x, bias):
    return torch.empty_like(x)


@bias_gelu.register_kernel("cuda")
def _(x, bias):
    return mlp_fused._bias_gelu_cuda(x, bias)


# ---------------------------------------------------------------------------
# softmax_dropout (the forward kernel)
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpudl::softmax_dropout", mutates_args=())
def softmax_dropout_fwd(logits: Tensor, kvmask: Optional[Tensor],
                        seed: Tensor, causal: bool, rate: float,
                        out_dtype: torch.dtype) -> Tensor:
    return softmax_dropout.softmax_dropout_ref(logits, kvmask, seed, causal,
                                               rate, out_dtype)


@softmax_dropout_fwd.register_fake
def _(logits, kvmask, seed, causal, rate, out_dtype):
    return torch.empty(logits.shape, dtype=out_dtype, device=logits.device)


@softmax_dropout_fwd.register_kernel("cuda")
def _(logits, kvmask, seed, causal, rate, out_dtype):
    return softmax_dropout._sd_fwd_cuda(logits, kvmask, seed, causal, rate,
                                        out_dtype)


# ---------------------------------------------------------------------------
# segmented LoRA
# ---------------------------------------------------------------------------


def _pools(a, b, a_scale, b_scale) -> dict:
    pools = {"a": a, "b": b}
    if a_scale is not None:
        pools.update(a_scale=a_scale, b_scale=b_scale)
    return pools


@torch.library.custom_op("tpudl::segmented_lora", mutates_args=())
def seg_lora(x: Tensor, a: Tensor, b: Tensor, a_scale: Optional[Tensor],
             b_scale: Optional[Tensor], table: Tensor, scale: Tensor,
             base: Optional[Tensor]) -> Tensor:
    """One site's delta (``base + delta`` given ``base``); the pools as
    their tensors (``a_scale``/``b_scale`` for int8 pages)."""
    return segmented_lora.segmented_lora_ref(
        x, _pools(a, b, a_scale, b_scale), table, scale, base)


@seg_lora.register_fake
def _(x, a, b, a_scale, b_scale, table, scale, base):
    if base is not None:
        return torch.empty_like(base)
    return x.new_empty(tuple(x.shape[:-1]) + (b.shape[-1],))


@seg_lora.register_kernel("cuda")
def _(x, a, b, a_scale, b_scale, table, scale, base):
    return segmented_lora._seg_lora_cuda(
        x, _pools(a, b, a_scale, b_scale), table, scale, base)


def seg_lora_op(x, pools, table, scale, base):
    """``tpudl::segmented_lora`` on a pool dict (or ``SitePools``)."""
    return seg_lora(x, pools["a"], pools["b"], pools.get("a_scale"),
                    pools.get("b_scale"), table, scale, base)


# ---------------------------------------------------------------------------
# the weight-only quantized product
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpudl::quant_dot", mutates_args=())
def quant_dot_op(x: Tensor, qvalues: Tensor, qscale: Tensor) -> Tensor:
    """``(x @ qvalues^T) * qscale`` in x's dtype, f32 accumulation."""
    return quant_dot.quant_matmul_ref(x, qvalues, qscale)


@quant_dot_op.register_fake
def _(x, qvalues, qscale):
    return x.new_empty(tuple(x.shape[:-1]) + (qvalues.shape[0],))


@quant_dot_op.register_kernel("cuda")
def _(x, qvalues, qscale):
    return quant_dot._quant_dot_cuda(x, qvalues, qscale)


def _quant_dot_setup(ctx, inputs, output):
    _, qvalues, qscale = inputs
    ctx.save_for_backward(qvalues, qscale)


def _quant_dot_backward(ctx, g):
    qvalues, qscale = ctx.saved_tensors
    w = (qvalues.float() * qscale[:, None]).to(g.dtype)
    return torch.matmul(g, w), None, None


quant_dot_op.register_autograd(_quant_dot_backward,
                               setup_context=_quant_dot_setup)


#: The op names an exported graph holds, as ``str(node.target)`` prints
#: them (``tpudl.rms_norm.default`` ...).
OPS = ("rms_norm", "layer_norm", "swiglu", "bias_gelu", "softmax_dropout",
       "segmented_lora", "quant_dot")


def graph_ops(graph_module) -> dict:
    """``{op name: node count}`` of the ``tpudl::`` nodes in a traced or
    exported graph (``ExportedProgram.graph_module`` or an FX graph
    module), its submodules' graphs included."""
    counts: dict = {}
    for module in graph_module.modules():
        graph = getattr(module, "graph", None)
        for node in graph.nodes if graph is not None else ():
            target = str(node.target)
            if node.op == "call_function" and target.startswith("tpudl."):
                name = target.split(".")[1]
                counts[name] = counts.get(name, 0) + 1
    return counts
