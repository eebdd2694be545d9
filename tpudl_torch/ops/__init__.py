"""Ops with hand-written Hopper kernels (``csrc/``) and their plain
PyTorch versions: LayerNorm and RMSNorm (+residual) forward and backward,
bias+GeLU forward and backward, SwiGLU forward and backward, masked
softmax + attention dropout forward and backward (``softmax_dropout``,
with the Philox keep mask of ``keep_mask``), flash attention
(``flash_attention``), whole-row attention at S <= 512
(``fused_attention``), softmax cross-entropy forward and backward, and
the segmented multi-tenant LoRA delta (``segmented_lora``) and the
weight-only int8 / e4m3 product (``quant_dot``); and the plain ops
around them (attention, dropout, the MoE MLP ``moe``) and the
delayed-scaling fp8 product (``fp8_dot``, ``Fp8Dense``:
``torch._scaled_mm`` on the card).
The forward kernels are also ops of the dispatcher,
``torch.ops.tpudl.*`` (``library``), which ``torch.export`` traces into
its artifacts.

``softmax_dropout``, ``quant_dot``, ``moe`` and the attention and LoRA
modules are reached as modules (``tpudl_torch.ops.softmax_dropout`` ...); their entry points are
not re-exported here, so the module names stay importable."""

from tpudl_torch.ops.cross_entropy import (  # noqa: F401
    softmax_cross_entropy,
    softmax_cross_entropy_ref,
    xent_bwd,
    xent_bwd_ref,
)
# The function shadows its module's name here (tpudl.ops does the same):
# reach the module as ``importlib.import_module("tpudl_torch.ops.fp8_dot")``
# or ``from tpudl_torch.ops.fp8_dot import ...``.
from tpudl_torch.ops.fp8_dot import Fp8Dense, fp8_dot  # noqa: F401
from tpudl_torch.ops.mlp_fused import (  # noqa: F401
    bias_gelu,
    bias_gelu_bwd,
    bias_gelu_bwd_ref,
    bias_gelu_ref,
    swiglu,
    swiglu_ref,
)
from tpudl_torch.ops.norms import (  # noqa: F401
    fused_ops_impl,
    layer_norm,
    layer_norm_ref,
    norm_bwd,
    norm_bwd_ref,
    resolve_impl,
    rms_norm,
    rms_norm_ref,
)
# Registers the tpudl:: ops the wrappers above dispatch to.
from tpudl_torch.ops import library  # noqa: E402,F401
