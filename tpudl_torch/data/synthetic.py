"""Synthetic datasets for smoke tests and benchmarks: a copy of
tpudl.data.synthetic (numpy only; the same seed gives the same batches
as the JAX package), plus ``to_device``, which puts a batch on a device.

Learnable synthetic data (class-conditional signal, so loss genuinely
decreases) stands in for CIFAR-10 / SST-2, which cannot be downloaded.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def synthetic_classification_batches(
    batch_size: int,
    image_shape: Tuple[int, int, int] = (32, 32, 3),
    num_classes: int = 10,
    seed: int = 0,
    signal: float = 2.0,
    num_batches: Optional[int] = None,
) -> Iterator[dict]:
    """Infinite (or bounded) NHWC image batches with class-dependent signal.

    Each class k gets a fixed low-frequency pattern (coarse 4x4 random grid
    upsampled to full resolution), which conv stacks with pooling learn.
    """
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    coarse = rng.normal(size=(num_classes, 4, 4, c)).astype(np.float32)
    reps_h, reps_w = (h + 3) // 4, (w + 3) // 4
    directions = np.repeat(np.repeat(coarse, reps_h, axis=1), reps_w, axis=2)
    directions = directions[:, :h, :w, :]
    directions /= np.abs(directions).max()
    i = 0
    while num_batches is None or i < num_batches:
        labels = rng.integers(0, num_classes, size=(batch_size,))
        images = rng.normal(size=(batch_size, *image_shape)).astype(np.float32)
        images += signal * directions[labels]
        yield {"image": images, "label": labels.astype(np.int32)}
        i += 1


def synthetic_token_batches(
    batch_size: int,
    seq_len: int = 128,
    vocab_size: int = 1000,
    num_classes: int = 2,
    seed: int = 0,
    num_batches: Optional[int] = None,
) -> Iterator[dict]:
    """Token-classification batches where the label is signalled by the
    frequency of a class-specific marker token — learnable by attention."""
    rng = np.random.default_rng(seed)
    marker_tokens = rng.integers(10, vocab_size, size=(num_classes,))
    i = 0
    while num_batches is None or i < num_batches:
        labels = rng.integers(0, num_classes, size=(batch_size,))
        ids = rng.integers(10, vocab_size, size=(batch_size, seq_len))
        for b in range(batch_size):
            pos = rng.integers(1, seq_len, size=(seq_len // 8,))
            ids[b, pos] = marker_tokens[labels[b]]
        ids[:, 0] = 1  # [CLS]-style token
        yield {
            "input_ids": ids.astype(np.int32),
            "attention_mask": np.ones((batch_size, seq_len), np.int32),
            "label": labels.astype(np.int32),
        }
        i += 1


def to_device(batch: dict, device="cuda") -> dict:
    """The batch's arrays as tensors on ``device`` (integer columns keep
    their dtype; tensors already there are passed through)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
