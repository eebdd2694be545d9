"""Inference latency harness: the port's counterpart of
tpudl.export.latency.

It mends what the reference's harness measured wrongly (reference
notebooks/cv/onnx_experiments.py:90-104,130-139): warm-up calls are
excluded, host -> device transfer is timed apart from compute, and
percentiles are reported, not only the mean. Every timing window ends
with a one-element host readback per output tensor (``_sync``), which
waits for the card's work without copying whole outputs back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Percentile summary of one timing series (milliseconds); only
    post-warm-up samples should enter it."""

    count: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    min_ms: float
    max_ms: float

    @classmethod
    def from_ms(cls, samples_ms: Sequence[float]) -> "LatencyStats":
        xs = np.asarray(samples_ms, dtype=np.float64)
        if xs.size == 0:
            raise ValueError(
                "LatencyStats needs at least one sample (callers decide "
                "how to render an empty series)")
        return cls(
            count=int(xs.size),
            mean_ms=float(xs.mean()),
            p50_ms=float(np.percentile(xs, 50)),
            p95_ms=float(np.percentile(xs, 95)),
            p99_ms=float(np.percentile(xs, 99)),
            min_ms=float(xs.min()),
            max_ms=float(xs.max()),
        )

    @classmethod
    def from_seconds(cls, samples_s: Sequence[float]) -> "LatencyStats":
        return cls.from_ms(np.asarray(samples_s, dtype=np.float64) * 1e3)

    def as_dict(self) -> dict:
        """``latency_benchmark``'s stats (mean/p50/p95/p99/min/max, no
        count)."""
        return {
            "mean_ms": self.mean_ms,
            "p50_ms": self.p50_ms,
            "p95_ms": self.p95_ms,
            "p99_ms": self.p99_ms,
            "min_ms": self.min_ms,
            "max_ms": self.max_ms,
        }

    def percentiles(self, digits: int = 3) -> dict:
        """{p50,p95,p99}_ms, rounded."""
        return {
            "p50_ms": round(self.p50_ms, digits),
            "p95_ms": round(self.p95_ms, digits),
            "p99_ms": round(self.p99_ms, digits),
        }


def _sync(out) -> float:
    """Wait for ``out`` by reading one element of each tensor leaf back to
    the host (never a whole output)."""
    total = 0.0
    for leaf in _pytree.tree_leaves(out):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel():
                total += float(leaf.reshape(-1)[0])
        elif isinstance(leaf, (int, float, np.ndarray, np.generic)):
            total += float(np.asarray(leaf).ravel()[0])
    return total


def _place(host_args, device):
    return _pytree.tree_map(
        lambda a: torch.as_tensor(a).to(device)
        if isinstance(a, (torch.Tensor, np.ndarray)) else a, tuple(host_args))


def latency_benchmark(fn: Callable, host_args: Sequence[Any],
                      device=None, warmup: int = 5, iters: int = 30,
                      graph: bool = False) -> dict:
    """Benchmark ``fn(*args)`` with transfer and compute timed apart.
    ``host_args`` (tensors or arrays, in any tree) are copied to
    ``device`` (default: the card) in each transfer window; compute runs
    on one placed copy. ``graph=True`` times the call replayed from a
    CUDA graph captured after the warm-up (tpudl_torch.graphs.Graph)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    device = torch.device("cuda" if device is None else device)

    transfer_ms = []
    placed = None
    for _ in range(warmup):
        placed = _place(host_args, device)
        _sync(placed)
    for _ in range(iters):
        t0 = time.perf_counter()
        placed = _place(host_args, device)
        _sync(placed)
        transfer_ms.append((time.perf_counter() - t0) * 1e3)

    # warmup=0 means the first timed iteration includes the first call's
    # setup (the kernels' build, cuBLAS and cuDNN).
    call = fn
    with torch.no_grad():
        out = None
        for _ in range(warmup):
            out = fn(*placed)
        if out is not None:
            _sync(out)
        if graph:
            from tpudl_torch.graphs import Graph

            g = Graph()
            out = g.capture(fn, *placed)
            call = g.replay
        compute_ms = []
        for _ in range(iters):
            t0 = time.perf_counter()
            res = call(*([] if graph else placed))
            _sync(out if graph else res)
            compute_ms.append((time.perf_counter() - t0) * 1e3)

    return {
        "device": str(device),
        "iters": iters,
        "warmup": warmup,
        "transfer": LatencyStats.from_ms(transfer_ms).as_dict(),
        "compute": LatencyStats.from_ms(compute_ms).as_dict(),
    }
