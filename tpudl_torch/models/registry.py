"""Model registry: config model names -> the port's modules (the
counterpart of tpudl.models.registry, BERT sizes only)."""

from __future__ import annotations

from typing import Any

import torch

from tpudl_torch.models.bert import (
    BERT_BASE,
    BERT_LARGE,
    BERT_TINY,
    BertForSequenceClassification,
)

#: BertConfig factories by size name (tpudl_torch.models.bert).
_BERT_SIZES = {
    "bert-tiny": BERT_TINY,
    "bert-base": BERT_BASE,
    "bert-large": BERT_LARGE,
}

#: tpudl's other model names, with the ROADMAP item that ports each.
_NOT_PORTED = {
    "resnet": "queue A item 5 (the CV path)",
    "llama": "queue A item 4 (the non-decode Llama forward)",
}


def build_model(name: str, num_classes: int, device="cuda", **kwargs: Any):
    """Build the module for a config ``model`` name (tpudl_torch.config)
    on ``device``, its weights drawn from torch's default generator
    (``create_train_state`` redraws them from a seeded one). ``dtype``
    defaults to bf16; other keyword arguments go to the config."""
    dtype = kwargs.pop("dtype", torch.bfloat16)
    if name in _BERT_SIZES:
        cfg = _BERT_SIZES[name](num_labels=num_classes, dtype=dtype, **kwargs)
        return BertForSequenceClassification(cfg, device=device)
    for prefix, item in _NOT_PORTED.items():
        if name.startswith(prefix):
            raise NotImplementedError(
                f"model {name!r} is not ported to tpudl_torch yet: ROADMAP "
                f"{item}"
            )
    raise ValueError(f"unknown model name: {name!r}")
