"""LoRA: low-rank adapters over a frozen base — the port's counterpart of
the single-tenant half of tpudl.models.lora.

- ``LoRALinear`` is tpudl's ``LoRADense`` without a bias (the Llama
  projections): a frozen base ``weight`` ``[out, in]`` in the compute
  dtype, plus ``lora_a`` ``[in, r]`` drawn from normal(1/r) and
  ``lora_b`` ``[r, out]`` zeros, both f32 masters in tpudl's
  orientation. ``y = x W^T + ((x A) B) * (alpha / r)``, with A and B cast
  to the compute dtype at use and each product rounded to it, as
  ``LoRADense`` computes it.
- ``lora_optimizer`` is the freeze: it marks every parameter but the
  adapters and the named extra leaves ``requires_grad_(False)``.
  Autograd then computes no gradient for them, and ``TrainState.params``
  (tpudl_torch.train.loop) hands the optimizer only the parameters that
  require a gradient, so frozen ones get no moments, no updates and no
  part in the global clip norm — what tpudl's ``optax.multi_transform``
  with ``set_to_zero`` does.
- ``is_lora_param``, ``lora_param_labels``, ``trainable_param_count`` and
  ``merge_lora`` work on '.'-joined state_dict names (tpudl's work on
  '/'-joined tree paths).

The multi-tenant adapter views of tpudl (``AdapterView``,
``adapter_delta``, extract/strip/merge_adapter) wait for ROADMAP queue A
item 3.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LoRALinear(nn.Module):
    """A bias-free projection with a rank-``rank`` adapter; see the module
    docstring. The base ``weight`` is created frozen."""

    def __init__(self, d_in: int, d_out: int, rank: int, alpha: float = 16.0,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if rank <= 0:
            raise ValueError(f"LoRALinear needs rank > 0, got {rank}")
        self.rank, self.alpha, self.dtype = rank, alpha, dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=dtype, device=device),
            requires_grad=False)
        self.lora_a = nn.Parameter(
            torch.empty(d_in, rank, dtype=torch.float32, device=device))
        self.lora_b = nn.Parameter(
            torch.empty(rank, d_out, dtype=torch.float32, device=device))

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def forward(self, x):
        y = F.linear(x, self.weight)
        delta = (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(self.dtype)
        if self.scaling != 1.0:
            # alpha = r (the configs' 16 / 16) multiplies by exactly 1:
            # skip the pass over [tokens, out].
            delta = delta * self.scaling
        return y + delta


def is_lora_param(name: str) -> bool:
    """Whether a '.'-joined parameter name is an adapter leaf."""
    return name.endswith("lora_a") or name.endswith("lora_b")


def lora_param_labels(names: Iterable[str],
                      extra_trainable: Iterable[str] = ()) -> Dict[str, str]:
    """name -> 'train' / 'freeze' (tpudl's labels): adapters, and names
    containing any ``extra_trainable`` substring (e.g. "classifier"),
    train."""
    extra = tuple(extra_trainable)
    return {n: "train" if is_lora_param(n) or any(e in n for e in extra)
            else "freeze" for n in names}


def trainable_param_count(params: Dict[str, torch.Tensor],
                          extra_trainable: Iterable[str] = ()
                          ) -> Tuple[int, int]:
    """(trainable, total) parameter counts under the LoRA split."""
    labels = lora_param_labels(params, extra_trainable)
    total = sum(p.numel() for p in params.values())
    trainable = sum(p.numel() for n, p in params.items()
                    if labels[n] == "train")
    return trainable, total


def merge_lora(params: Dict[str, torch.Tensor],
               alpha_by_rank: Optional[float] = None
               ) -> Dict[str, torch.Tensor]:
    """Fold each adapter into its base weight (``W += (A B)^T * alpha /
    r``, default alpha 16 as tpudl's) and drop the adapter leaves: a
    state_dict of the model with ``lora_rank=0``."""
    out = dict(params)
    for name in [n for n in params if n.endswith(".lora_a")]:
        site = name[: -len(".lora_a")]
        a, b = out.pop(f"{site}.lora_a"), out.pop(f"{site}.lora_b")
        scaling = (alpha_by_rank if alpha_by_rank is not None
                   else 16.0 / a.shape[-1])
        w = out[f"{site}.weight"]
        out[f"{site}.weight"] = (w.float() + (a.float() @ b.float()).T
                                 * scaling).to(w.dtype)
    return out


def lora_optimizer(tx, model: nn.Module,
                   extra_trainable: Iterable[str] = ()):
    """Freeze ``model``'s base: every parameter but the adapters and the
    ``extra_trainable`` ones gets ``requires_grad_(False)``, those get
    ``requires_grad_(True)``. Returns ``tx`` itself: the train state
    hands it only the parameters that require a gradient."""
    labels = lora_param_labels(dict(model.named_parameters()), extra_trainable)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "train")
    return tx
