"""Model registry: config model names -> the port's modules (the
counterpart of tpudl.models.registry: the ResNet sizes, the BERT sizes
and the Llama sizes as sequence classifiers)."""

from __future__ import annotations

from typing import Any

import torch

from tpudl_torch.models.bert import (
    BERT_BASE,
    BERT_LARGE,
    BERT_TINY,
    BertForSequenceClassification,
)
from tpudl_torch.models.resnet import RESNET_SIZES

#: BertConfig factories by size name (tpudl_torch.models.bert).
_BERT_SIZES = {
    "bert-tiny": BERT_TINY,
    "bert-base": BERT_BASE,
    "bert-large": BERT_LARGE,
}

def build_llama(name: str, num_classes: int, device="cuda",
                dtype=torch.bfloat16, **kwargs: Any):
    """tpudl.models.llama.build_llama: 'llama-tiny' / 'llama3-1b' /
    'llama3-8b' with composable suffixes — '-lora' turns on rank-16
    adapters (override with lora_rank=); '-moe' swaps every MLP for an
    8-expert MoE (override with moe_experts=) — as a
    LlamaForSequenceClassification."""
    from tpudl_torch.models.llama import (
        LLAMA_SIZES,
        LlamaForSequenceClassification,
    )

    base, lora, moe = name, False, False
    while True:
        if base.endswith("-lora"):
            base, lora = base.removesuffix("-lora"), True
        elif base.endswith("-moe"):
            base, moe = base.removesuffix("-moe"), True
        else:
            break
    if base not in LLAMA_SIZES:
        raise ValueError(
            f"unknown llama size {base!r}; available: {sorted(LLAMA_SIZES)}"
        )
    if lora:
        kwargs.setdefault("lora_rank", 16)
    if moe:
        kwargs.setdefault("moe_experts", 8)
    cfg = LLAMA_SIZES[base](num_labels=num_classes, dtype=dtype, **kwargs)
    return LlamaForSequenceClassification(cfg, device=device)


def build_model(name: str, num_classes: int, device="cuda", **kwargs: Any):
    """Build the module for a config ``model`` name (tpudl_torch.config)
    on ``device``, its weights drawn from torch's default generator
    (``create_train_state`` redraws them from a seeded one). ``dtype``
    defaults to bf16; other keyword arguments go to the config (for a
    ResNet, to the module: ``small_inputs=True`` is the CIFAR stem)."""
    dtype = kwargs.pop("dtype", torch.bfloat16)
    if name.startswith("resnet"):
        if name not in RESNET_SIZES:
            raise ValueError(f"unknown resnet size {name!r}; available: "
                             f"{sorted(RESNET_SIZES)}")
        return RESNET_SIZES[name](num_classes=num_classes, dtype=dtype,
                                  device=device, **kwargs)
    if name in _BERT_SIZES:
        cfg = _BERT_SIZES[name](num_labels=num_classes, dtype=dtype, **kwargs)
        return BertForSequenceClassification(cfg, device=device)
    if name.startswith("llama"):
        return build_llama(name, num_classes, device, dtype, **kwargs)
    raise ValueError(f"unknown model name: {name!r}")
