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
  '/'-joined tree paths). An fp8 site with adapters
  (tpudl_torch.ops.fp8_dot.Fp8Dense, ``fp8_train`` with ``lora_rank``)
  has LoRALinear's leaves (``weight``, ``lora_a``, ``lora_b``), so these,
  ``lora_optimizer`` and ``extract_adapters`` treat it alike.

The multi-tenant half (tpudl_torch.serve.lora's model side):
``AdapterView`` threads per-slot page-table rows into an AdapterPool's
rank-unit pools through the decode path, and ``adapter_delta`` adds each
slot's own adapter after a base projection through one
tpudl_torch.ops.segmented_lora call per site. ``extract_adapters``,
``as_flat_adapters``, ``strip_adapters`` and ``merge_adapter`` split a
LoRA state_dict into the resident base and the per-tenant adapter, and
fold one adapter back (the sequential reference of the multi-tenant
parity gate). An adapter in flat form is ``{site_path: {"lora_a": [in,
r], "lora_b": [r, out]}}``; the port's site paths are '.'-joined module
names (``model.layer_0.attention.q_proj``), tpudl's '/'-joined ones are
taken too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudl_torch.quant.dense import QuantWeight


class LoRALinear(QuantWeight, nn.Module):
    """A bias-free projection with a rank-``rank`` adapter; see the module
    docstring. The base ``weight`` is created frozen. Bound to a
    state_dict whose base is a quantized pair (``X.qvalues``, ``X.qscale``;
    tpudl_torch.quant), the base product runs
    tpudl_torch.quant.dense.quant_dot and the adapters stay full precision
    on top (tpudl's ``LoRADense`` over a quantized kernel)."""

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
        self._init_quant_weight()

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def forward(self, x):
        y = self.base_product(x, self.dtype)
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


# ---------------------------------------------------------------------------
# Multi-tenant adapter serving (tpudl_torch.serve.lora's model-side half)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdapterView:
    """Per-dispatch multi-tenant adapter addressing.

    ``pools`` is the AdapterPool's ``{layer_name: {site: {"a", "b"[,
    "a_scale", "b_scale"]}}}`` of device tensors; ``table`` ([B, r_max]
    int32, on the pools' device) maps each slot's rank units to pages (0
    = the never-written all-zero page, so empty slots and short ranks add
    nothing); ``scale`` ([B] f32) is each slot's alpha / rank. ``impl``
    is the segmented kernel's dispatch seam. ``batch`` is the table's and
    the scale's ``segmented_lora.batch_args`` when the view runs the
    kernel (held once per dispatch), else None."""

    pools: Any
    table: torch.Tensor
    scale: torch.Tensor
    impl: str = "auto"
    batch: Optional[tuple] = None

    def for_layer(self, name: str) -> Optional["AdapterView"]:
        """The sub-view one decoder block consumes (its sites keyed
        "q_proj", "gate_proj", ...); None when no pool adapts the
        layer."""
        pools = self.pools.get(name)
        if pools is None:
            return None
        return dataclasses.replace(self, pools=pools)


def adapter_delta(view: Optional[AdapterView], site: str, x, base=None):
    """The multi-tenant LoRA delta of one projection site (0 when the
    view or the site's pools are absent); callers add it onto the base
    projection, ``y = proj(x) + adapter_delta(view, name, x)`` in x's
    dtype as tpudl adds it, or pass ``base=proj(x)`` to get that sum from
    the one segmented-LoRA call (``base`` itself when nothing adapts the
    site)."""
    pools = None if view is None else view.pools.get(site)
    if pools is None:
        return 0 if base is None else base
    from tpudl_torch.ops import segmented_lora as sl

    if view.batch is not None and isinstance(pools, sl.SitePools) \
            and pools.args is not None:
        # Pools and addressing already held to the kernel's contract.
        return sl.launch(x, pools.args, view.batch, base)
    return sl.segmented_lora(x, pools, view.table, view.scale, base=base,
                             impl=view.impl)


def extract_adapters(params: Dict[str, Any]) -> Dict[str, dict]:
    """The adapters of a LoRA state_dict in flat form, ``{site_path:
    {"lora_a": [in, r], "lora_b": [r, out]}}`` (site_path = the
    '.'-joined module name, e.g. ``model.layer_0.attention.q_proj``):
    the per-tenant unit tpudl_torch.serve.lora.AdapterPool registers.
    The base weights stay behind: one resident base serves every
    tenant."""
    return {name[: -len(".lora_a")]: {
        "lora_a": params[name],
        "lora_b": params[name[: -len(".lora_a")] + ".lora_b"]}
        for name in params if name.endswith(".lora_a")}


def as_flat_adapters(tree: Any) -> Dict[str, dict]:
    """An adapter argument in flat form: a ``{site_path: {"lora_a",
    "lora_b"}}`` dict passes through; anything else is a LoRA state_dict
    and is extracted. The one detection rule AdapterPool.register, the
    serving entry's rank probe and the parity gate share."""
    if tree and all(isinstance(v, dict) and {"lora_a", "lora_b"} <= set(v)
                    for v in tree.values()):
        return dict(tree)
    return extract_adapters(tree)


def strip_adapters(params: Dict[str, Any]) -> Dict[str, Any]:
    """The base state_dict without adapter leaves (the resident-once half
    of the split; ``extract_adapters`` is the per-tenant half)."""
    return {k: v for k, v in params.items() if not is_lora_param(k)}


def as_f32(x, device=None) -> torch.Tensor:
    """An adapter factor (a tensor, or an array such as tpudl's) as an f32
    tensor on ``device`` (default: where a tensor lies, else the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.detach().to(device or x.device, torch.float32)


def merge_adapter(base_params: Dict[str, torch.Tensor],
                  adapter: Dict[str, dict], alpha: float = 16.0
                  ) -> Dict[str, torch.Tensor]:
    """Fold ONE tenant's flat-form adapter into a copy of the base
    state_dict (``W += ((A B) alpha / r)^T`` at every adapted site, in
    f32, rounded once to the weight's dtype) — the sequential
    one-adapter-at-a-time reference the multi-tenant parity gate
    compares against."""
    merged = dict(base_params)
    for path, factors in adapter.items():
        key = path.replace("/", ".") + ".weight"
        if key not in merged:
            raise ValueError(f"no weight at adapter site {path!r}")
        w = merged[key]
        a, b = (as_f32(factors[k], w.device) for k in ("lora_a", "lora_b"))
        delta = (a @ b) * (alpha / a.shape[-1])
        merged[key] = (w.float() + delta.T).to(w.dtype)
    return merged
