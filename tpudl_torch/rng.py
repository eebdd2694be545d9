"""Seeded generators: the port's counterpart of ``jax.random.fold_in``.

``fold_in(seed, index, device)`` is a ``torch.Generator`` of its own for
each (seed, index) pair — a sampled request's token ``index``, a train
step's dropout masks — so a stream's draws depend on nothing but the
pair. The pair is packed into 64 bits and mixed (splitmix64's
finalizer, a bijection) because the CPU generator keeps only the low 32
bits of its seed. The bits are torch's, not JAX's.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def fold_in(seed: int, index: int, device="cuda") -> torch.Generator:
    x = (((int(seed) << 32) | int(index)) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return torch.Generator(device=device).manual_seed(x ^ (x >> 31))
