"""Attention constants shared with the JAX package.

The port's counterpart of tpudl.ops.attention, cut to what the decode
path needs; ``dot_product_attention`` / ``attend`` and the flash, ring
and fused kernels behind them wait for the non-decode forward.
"""

from __future__ import annotations

import numpy as np

#: Large negative fill for masked logits, safe in bf16 — the same finite
#: value as tpudl.ops.attention.MASK_VALUE.
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
