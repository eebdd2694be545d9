"""Quantized product with dequantization fused into the contraction: the
port's counterpart of tpudl.quant.dense.

For symmetric per-output-channel quantization ``x @ (q * scale)^T ==
(x @ q^T) * scale``: the scale can be applied AFTER the contraction, so
the fused form contracts the raw int8/e4m3 values in f32 and pays one
per-channel multiply; the full-precision weight never exists. Same
``impl`` seam as tpudl:

- ``"reference"`` is the composite: dequantize the weight to the compute
  dtype, then the plain product in the compute dtype (any device);
- ``"fused"`` is the contraction in f32 over the raw values, one f32
  multiply by the scale, a cast to the compute dtype: on a CUDA tensor
  the hand-written kernel (tpudl_torch.ops.quant_dot, csrc/quant_dot.cu;
  a shape the kernel does not take raises), on a CPU tensor an error;
- ``"auto"``: the kernel on a CUDA tensor, the plain twin of the fused
  form on a CPU tensor.

``QuantDense`` is the module the models' ``weight_dtype`` seams put at
the quantizable sites (tpudl's ``QuantDense``). Built, it holds the
full-precision ``weight`` ``[out, in]`` (and an f32 ``bias``) that a
plain projection holds, so ``init_params`` and a full-precision
checkpoint are the same tree; bound to a state_dict, it dispatches on
what the state_dict holds: ``X.weight`` runs the plain projection's exact
math (``F.linear`` in the compute dtype), ``X.qvalues`` and ``X.qscale``
(two buffers; ``weight`` is then dropped) run ``quant_dot``. The bias is
added after the cast, in the compute dtype. ``QuantWeight`` is that
dispatch, which ``tpudl_torch.models.lora.LoRALinear`` shares for a LoRA
adapter over a quantized base.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpudl_torch.ops.norms import resolve_impl as _device_impl
from tpudl_torch.ops.quant_dot import quant_matmul
from tpudl_torch.quant.quantize import dequantize_leaf, is_quantized


def resolve_impl(impl: str) -> str:
    """``impl`` -> "fused" | "reference" (tpudl's meaning): "auto" is the
    fused form, which the device then dispatches (see the module
    docstring)."""
    if impl == "auto":
        return "fused"
    if impl not in ("fused", "reference"):
        raise ValueError(
            f"impl must be 'auto', 'fused' or 'reference', got {impl!r}"
        )
    return impl


def quant_dot(x: torch.Tensor, kernel: Any, *, impl: str = "auto",
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ W^T`` for a quantized pair or a plain ``[out, in]`` weight,
    in ``compute_dtype`` (default ``x``'s). A plain weight contracts in
    the compute dtype; a pair runs the ``impl`` form (module docstring)."""
    if compute_dtype is None:
        compute_dtype = x.dtype
    x = x.to(compute_dtype)
    if not is_quantized(kernel):
        return F.linear(x, kernel.to(compute_dtype))
    if resolve_impl(impl) == "reference":
        return F.linear(x, dequantize_leaf(kernel, compute_dtype))
    # "auto" on the CPU is the plain twin; "fused" there raises.
    _device_impl(impl, x.device)
    return quant_matmul(x, kernel["qvalues"], kernel["qscale"])


class QuantWeight:
    """Mixin of a module with a ``weight`` ``[out, in]`` that may be bound
    quantized: ``weight`` (a Parameter) or the ``qvalues`` / ``qscale``
    buffers, whichever the state_dict it loads holds (see the module
    docstring). Call ``_init_quant_weight`` after ``weight`` exists."""

    def _init_quant_weight(self) -> None:
        self._weight_shape = tuple(self.weight.shape)
        self._weight_dtype = self.weight.dtype
        self._weight_grad = self.weight.requires_grad
        self.register_buffer("qvalues", None)
        self.register_buffer("qscale", None)

    @property
    def quantized(self) -> bool:
        return self.qvalues is not None

    def quant_leaf(self) -> dict:
        return {"qvalues": self.qvalues, "qscale": self.qscale}

    def base_product(self, x: torch.Tensor, dtype: torch.dtype,
                     impl: str = "auto") -> torch.Tensor:
        """``x @ W^T`` in ``dtype``: ``quant_dot`` over the bound pair,
        else the plain product with ``weight`` cast to ``dtype``."""
        if self.qvalues is not None:
            return quant_dot(x, self.quant_leaf(), impl=impl,
                             compute_dtype=dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype))

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        quant = prefix + "qvalues" in state_dict
        if self.weight is not None:
            device = self.weight.device
            self._weight_grad = self.weight.requires_grad
        else:
            device = self.qvalues.device
        if quant:
            qdtype = state_dict[prefix + "qvalues"].dtype
            if self.qvalues is None or self.qvalues.dtype != qdtype:
                # Placeholders of the pair's shapes: the base loader checks
                # shapes against them, then assigns or copies.
                self.qvalues = torch.empty(self._weight_shape, dtype=qdtype,
                                           device=device)
                self.qscale = torch.empty(self._weight_shape[0],
                                          dtype=torch.float32, device=device)
            self.weight = None
        elif self.weight is None:
            self.weight = nn.Parameter(
                torch.empty(self._weight_shape, dtype=self._weight_dtype,
                            device=device),
                requires_grad=self._weight_grad)
            self.qvalues = self.qscale = None
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)


class QuantDense(QuantWeight, nn.Module):
    """A projection whose weight may be bound quantized (module
    docstring): ``forward(x, add_bias=True)`` in ``dtype``. ``masters``:
    the full-precision ``weight`` is an f32 master cast at use (BERT's
    ``Dense``), else it is stored in ``dtype`` (a Llama serving
    projection)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None,
                 use_bias: bool = False, masters: bool = False,
                 impl: str = "auto"):
        super().__init__()
        self.dtype, self.impl = dtype, impl
        self.weight = nn.Parameter(torch.empty(
            d_out, d_in, dtype=torch.float32 if masters else dtype,
            device=device))
        self.bias = nn.Parameter(torch.empty(
            d_out, dtype=torch.float32, device=device)) if use_bias else None
        self._init_quant_weight()

    def forward(self, x: torch.Tensor, add_bias: bool = True) -> torch.Tensor:
        if self.qvalues is None:
            # The plain projection's exact math (BERT's Dense, nn.Linear).
            bias = (self.bias.to(self.dtype)
                    if add_bias and self.bias is not None else None)
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)
        y = quant_dot(x, self.quant_leaf(), impl=self.impl,
                      compute_dtype=self.dtype)
        if add_bias and self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
