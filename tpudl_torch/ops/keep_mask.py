"""The in-kernel dropout contract, in plain PyTorch: the twin of
``csrc/philox.cuh``.

The port's counterpart of ``seed_cell`` / ``keep_mask`` in
tpudl/ops/pallas_utils.py. There the keep mask comes from the TPU's
hardware PRNG reseeded per grid cell, so its bits depend on the tiling.
Here it is a pure function of two uint32 seed words, the tensor's shape
and each element's flat index ``i`` in the unpadded tensor: the bits of
element ``i`` are word ``i mod 4`` of Philox4x32-10 with counter
``i // 4`` (a 128-bit integer: low word, high word, 0, 0) and key
``(seed[0], seed[1])``. An element is kept when ``bits >= round(rate *
2**32)`` — tpudl's threshold rule, not the uint8 k/256 rule of
tpudl_torch.ops.dropout — and the kept values are scaled by ``1 / (1 -
rate)`` at the nominal rate.

This module runs the same rounds in int64 arithmetic masked to 32 bits.
Each 32 x 32-bit product is formed from 16-bit halves of the counter
word, so no intermediate leaves the int64 range and the high and low
words are exact. The kernels and this twin therefore agree bit for bit,
on the card and on the CPU.

``draw_seed`` draws the two seed words from a step's ``torch.Generator``
(the counterpart of ``jax.random.bits(rng, (2,), uint32)``). They stay
on the generator's device as an int64 ``[2]`` tensor of values in
``[0, 2**32)``; the kernels read them through a pointer, so no launch
waits for the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """Two uint32 seed words from ``generator``, as an int64 ``[2]``
    tensor on the generator's device."""
    return torch.randint(0, 2**32, (2,), dtype=torch.int64,
                         generator=generator, device=generator.device)


def zero_seed(device) -> torch.Tensor:
    """The seed words a call without dropout passes (tpudl passes zeros)."""
    return torch.zeros(2, dtype=torch.int64, device=device)


def threshold(rate: float) -> int:
    """The uint32 threshold of ``rate``: keep when ``bits >= threshold``
    (tpudl.ops.pallas_utils.keep_mask)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 2.0**32)), _MASK32)


def _mulhilo(m: int, c: torch.Tensor):
    """(high, low) 32-bit words of ``m * c`` for a uint32 constant ``m``
    and int64 ``c`` holding uint32 values: with ``c = a * 2**16 + b``,
    ``m * a`` and ``m * b`` stay below 2**48."""
    ma = m * (c >> 16)
    low = m * (c & 0xFFFF) + ((ma & 0xFFFF) << 16)
    return (ma >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (the counter
    words ``c0..c3`` broadcast against each other; the key words may be
    ints or 0-d/1-element tensors). Returns the four output words."""
    k0 = k0 & _MASK32
    k1 = k1 & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: torch.Tensor, numel: int,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """The uint32 bits (as int64) of flat elements ``0 .. numel - 1``
    under the seed words ``seed`` (int64 ``[2]``)."""
    device = seed.device if device is None else device
    seed = seed.to(device=device, dtype=torch.int64)
    blocks = -(-numel // 4)
    q = torch.arange(blocks, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32_10(q & _MASK32, q >> 32, zero, zero, seed[0], seed[1])
    return torch.stack(words, dim=-1).reshape(-1)[:numel]


def keep_mask(seed: torch.Tensor, shape: Sequence[int], rate: float,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean keep mask of ``shape`` (True = keep, with probability
    ``1 - rate``) under the seed words ``seed``: the mask the kernels
    draw for a tensor of this shape."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    bits = philox_bits(seed, numel, device)
    return (bits >= threshold(rate)).reshape(shape)


def keep_words(seed: torch.Tensor, b: int, h: int, sq: int, skv: int,
               rate: float, device: Optional[torch.device] = None
               ) -> torch.Tensor:
    """The attention keep mask of a [b, h, sq, skv] score tensor in the
    row order the bf16 backwards' dQ launches write it for their dK/dV
    launches: int32 ``[b, h, sq, ceil(skv / 32)]``, bit ``kv % 32`` of
    word ``kv // 32`` set where element ``(b, h, q, kv)`` is kept (bits
    past ``skv`` clear; the kernels leave them unspecified)."""
    kept = keep_mask(seed, (b, h, sq, skv), rate, device)
    words = -(-skv // 32)
    pad = torch.zeros(b, h, sq, 32 * words - skv, dtype=torch.bool,
                      device=kept.device)
    bits = torch.cat([kept, pad], dim=-1).reshape(b, h, sq, words, 32)
    weights = torch.ones((), dtype=torch.int64, device=kept.device) << \
        torch.arange(32, dtype=torch.int64, device=kept.device)
    packed = (bits.long() * weights).sum(-1)
    # uint32 values into int32's range, two's complement.
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)
