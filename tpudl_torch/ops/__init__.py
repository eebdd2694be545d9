"""Ops with hand-written Hopper kernels (``csrc/``) and their plain
PyTorch versions: LayerNorm and RMSNorm (+residual) forward and backward,
bias+GeLU forward and backward, SwiGLU; and the plain ops around them
(attention, dropout)."""

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
