"""Ops with hand-written Hopper kernels (``csrc/``) and their plain
PyTorch versions: RMSNorm(+residual) and SwiGLU."""

from tpudl_torch.ops.mlp_fused import swiglu, swiglu_ref  # noqa: F401
from tpudl_torch.ops.norms import (  # noqa: F401
    fused_ops_impl,
    resolve_impl,
    rms_norm,
    rms_norm_ref,
)
