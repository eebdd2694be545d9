"""Low-precision weight tier: post-training quantization for serving, the
port's counterpart of tpudl.quant.

Decode is bound by streaming the weights (every parameter is read once
per generated token), so shrinking the resident weight bytes is the TPOT
lever that matches the int8 KV pages (tpudl_torch.models.paged).

- ``quantize.py``: rules over tpudl's tree paths select the leaves that
  quantize (attention and MLP projections) to symmetric per-output-
  channel int8 or e4m3; a quantized leaf is the ``{"qvalues",
  "qscale"}`` pair, in a state_dict ``X.qvalues`` and ``X.qscale`` in
  place of ``X.weight``.
- ``dense.py``: ``quant_dot``, the product with the scale after the
  contraction (the hand-written Hopper kernel on the card,
  tpudl_torch.ops.quant_dot), behind tpudl's ``impl`` seam, and
  ``QuantDense``, the module the Llama and BERT ``weight_dtype`` seams
  put at the quantizable sites.

End to end: ``ServeSession.from_model(..., weight_dtype="int8")`` serves
the quantized tree (with ``kv_dtype="int8"`` over int8 KV pages), and
tpudl_torch.export.decode exports the quantized programs.
"""

from tpudl_torch.quant.dense import (  # noqa: F401
    QuantDense,
    quant_dot,
    resolve_impl,
)
from tpudl_torch.quant.quantize import (  # noqa: F401
    BERT_QUANT_PATTERNS,
    E4M3_MAX,
    INT8_MAX,
    LLAMA_QUANT_PATTERNS,
    QUANT_DTYPES,
    SCALE_EPS,
    default_quant_rules,
    dequantize_leaf,
    dequantize_tree,
    is_quantized,
    match_quant_rules,
    quantize_leaf,
    quantize_model,
    quantize_tree,
    validate_weight_dtype,
    weight_bytes_report,
)
