"""Workload configurations: the port's counterpart of tpudl.config.

A copy of what the ported training paths need: ``OptimConfig``,
``TrainConfig`` and the five entries of BASELINE.json: ``configs[0]``
(``cifar10_resnet18``), ``configs[1]`` (``sst2_bert_base``),
``configs[2]`` (``imagenet_resnet50_dp``), ``configs[3]``
(``bert_large_v4_32``) and ``configs[4]`` (``llama3_8b_lora``). Each
equals tpudl's field for field but for tpudl's ``mesh`` and
``strategy``, which wait for the launcher and sharding port (ROADMAP
queue A item 7): the port runs each on one card, at its declared global
batch (accumulated where tpudl accumulates).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"  # adamw | sgd
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 1e-4
    momentum: float = 0.9  # sgd only
    b1: float = 0.9
    b2: float = 0.999
    #: AdamW first-moment dtype; the second moment stays f32 for
    #: numerical range.
    mu_dtype: str = "float32"  # float32 | bfloat16
    grad_clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"  # cosine | constant | linear


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    model: str  # resnet18 | resnet50 | bert-* | llama*[-lora]
    dataset: str  # cifar10 | imagenet | sst2
    global_batch_size: int = 128
    image_size: int = 32
    seq_len: int = 128
    num_classes: int = 10
    precision: str = "bf16"  # bf16 | f32
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    num_steps: int = 200
    log_every: int = 20
    accum_steps: int = 1
    label_smoothing: float = 0.0
    data_dir: Optional[str] = None  # parquet dir; None -> synthetic
    checkpoint_dir: Optional[str] = None
    seed: int = 0


CONFIGS = {
    # configs[0]: ResNet-18 on CIFAR-10, single-process smoke.
    "cifar10_resnet18": TrainConfig(
        name="cifar10_resnet18",
        model="resnet18",
        dataset="cifar10",
        global_batch_size=256,
        image_size=32,
        num_classes=10,
        optim=OptimConfig(name="sgd", learning_rate=0.1, warmup_steps=50,
                          total_steps=2000, weight_decay=5e-4),
        num_steps=2000,
    ),
    # configs[1]: BERT-base SST-2 fine-tune, single-process.
    "sst2_bert_base": TrainConfig(
        name="sst2_bert_base",
        model="bert-base",
        dataset="sst2",
        global_batch_size=32,
        seq_len=128,
        num_classes=2,
        optim=OptimConfig(name="adamw", learning_rate=2e-5, warmup_steps=100,
                          total_steps=2000, weight_decay=0.01,
                          mu_dtype="bfloat16"),
        num_steps=2000,
    ),
    # configs[2]: ResNet-50 on ImageNet (tpudl's mesh dp=-1 and strategy
    # "dp" wait for the launcher port): global batch 1024 as 8
    # microbatches of 128.
    "imagenet_resnet50_dp": TrainConfig(
        name="imagenet_resnet50_dp",
        model="resnet50",
        dataset="imagenet",
        global_batch_size=1024,
        image_size=224,
        num_classes=1000,
        optim=OptimConfig(name="sgd", learning_rate=0.4, warmup_steps=500,
                          total_steps=56300, weight_decay=1e-4),
        num_steps=56300,
        label_smoothing=0.1,
        accum_steps=8,
    ),
    # configs[3]: BERT-large fine-tune (tpudl's mesh (dp, fsdp 4) and
    # strategy "fsdp" wait for the launcher port): global batch 256 as 4
    # microbatches of 64, bf16 first moments. On one card that is ~335 M
    # parameters: f32 params and grads, bf16 mu and f32 nu, ~4.7 GB.
    "bert_large_v4_32": TrainConfig(
        name="bert_large_v4_32",
        model="bert-large",
        dataset="sst2",
        global_batch_size=256,
        seq_len=128,
        num_classes=2,
        optim=OptimConfig(name="adamw", learning_rate=3e-5, warmup_steps=200,
                          mu_dtype="bfloat16",
                          total_steps=5000, weight_decay=0.01),
        num_steps=5000,
        accum_steps=4,
    ),
    # configs[4]: Llama-3-8B LoRA fine-tune (tpudl's mesh (dp, fsdp 8,
    # tp 2) and strategy "lora" wait for the launcher port).
    "llama3_8b_lora": TrainConfig(
        name="llama3_8b_lora",
        model="llama3-8b-lora",
        dataset="sst2",
        global_batch_size=64,
        seq_len=2048,
        num_classes=2,
        optim=OptimConfig(name="adamw", learning_rate=1e-4, warmup_steps=100,
                          total_steps=1000, weight_decay=0.0),
        num_steps=1000,
    ),
}


def get_config(name: str, **overrides) -> TrainConfig:
    cfg = CONFIGS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
