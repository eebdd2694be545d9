"""Throughput and MFU accounting: the port's counterpart of the parts of
tpudl.train.metrics the training path uses (``transformer_train_flops``,
``mfu``, ``device_peak_flops``, ``Throughput``).

Peaks are the card's own, from NVIDIA's H100 data sheet (dense bf16
tensor-core rates, no sparsity). A CPU has no entry: MFU is a device
metric and is never computed from a CPU run.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

#: Dense bf16 peak FLOP/s per card, by a substring of
#: ``torch.cuda.get_device_name()`` (first match wins, most specific
#: first). NVIDIA H100 data sheet: SXM5 989.4 TFLOP/s, NVL 835, PCIe 756.
PEAK_FLOPS = (
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H100", 989e12),  # SXM5 ("NVIDIA H100 80GB HBM3")
)


def device_peak_flops(device=None) -> float:
    """Dense bf16 peak of the CUDA card ``device`` (default: the current
    one). Raises for a card with no entry, and without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_peak_flops needs a CUDA card")
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_FLOPS:
        if key in name:
            return peak
    raise ValueError(f"no dense bf16 peak known for {name!r}")


def transformer_train_flops(num_params: int, tokens_per_step: int) -> float:
    """6*N*D for a transformer forward and backward step."""
    return 6.0 * num_params * tokens_per_step


def mfu(
    flops_per_step: float,
    step_seconds: float,
    num_chips: int = 1,
    peak_per_chip: Optional[float] = None,
) -> float:
    if peak_per_chip is None:
        peak_per_chip = device_peak_flops()
    return flops_per_step / (step_seconds * num_chips * peak_per_chip)


def _sync(value) -> None:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class Throughput:
    """Steady-state throughput meter: skips ``warmup`` steps and waits
    for the card (``torch.cuda.synchronize``) only at the window's two
    ends, given a tensor the last step produced (``sync_value``)."""

    def __init__(self, items_per_step: int, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self._count = 0
        # warmup=0 means "count every step": the window opens at construction.
        self._start = time.perf_counter() if warmup == 0 else None
        self._measured_steps = 0

    def step(self, sync_value=None):
        self._count += 1
        if self._count == self.warmup:
            _sync(sync_value)
            self._start = time.perf_counter()
        elif self._count > self.warmup:
            self._measured_steps += 1

    def result(self, sync_value=None) -> dict:
        _sync(sync_value)
        if self._measured_steps == 0 or self._start is None:
            return {"steps_measured": 0, "seconds": 0.0, "items_per_sec": 0.0,
                    "step_ms": 0.0}
        elapsed = time.perf_counter() - self._start
        steps = self._measured_steps
        per_sec = self.items_per_step * steps / elapsed if elapsed > 0 else 0.0
        return {
            "steps_measured": steps,
            "seconds": elapsed,
            "items_per_sec": per_sec,
            "step_ms": 1000.0 * elapsed / steps if elapsed > 0 else 0.0,
        }
