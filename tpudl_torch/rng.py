"""Seeded generators: the port's counterpart of ``jax.random.fold_in``.

``fold_in(seed, index, device)`` is a ``torch.Generator`` of its own for
each (seed, index) pair — a sampled request's token ``index``, a train
step's dropout masks — so a stream's draws depend on nothing but the
pair. The pair is packed into 64 bits and mixed (splitmix64's
finalizer, a bijection) because the CPU generator keeps only the low 32
bits of its seed. The bits are torch's, not JAX's.

``fold_seed(seed, index)`` is that generator's 64-bit seed, which folds
again: microbatch ``a`` of a step draws from
``fold_in(fold_seed(rng, step), a)``, tpudl's
``fold_in(fold_in(rng, step), a)``. A seed above 32 bits (a folded one)
packs its low word beside the index and XORs its high word into the
index's word, so a seed of 32 bits or fewer packs as it always did.
"""

from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1
_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, index: int) -> int:
    seed, index = int(seed), int(index)
    packed = (seed << 32) | index
    if seed > _MASK32:
        packed ^= seed >> 32
    x = (packed + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, index: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(fold_seed(seed, index))
