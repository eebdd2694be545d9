"""Low-width-bits dropout: the port's counterpart of tpudl.ops.dropout.

A keep/drop decision needs nowhere near 32 bits of entropy: this module
draws uint8 bits and compares them with ``round(rate * 256)``, so the
effective drop rate quantizes to multiples of 1/256 (rate 0.1 becomes
26/256 ~ 0.1016) and the inverted-dropout rescale uses that effective
rate, as tpudl does. ``exact=True`` draws ``torch.bernoulli`` at the
nominal rate instead.

The bits come from an explicit ``torch.Generator`` (the counterpart of
the JAX ``rng`` key) and are the port's own: they do not reproduce JAX's
bits, so the two packages agree in distribution, not bit for bit. The
model's dropout calls draw from one generator in a fixed order, so a
forward with a generator seeded alike draws the same masks whatever the
dtype or kernel tier.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def quantized_rate(rate: float, exact: bool = False) -> float:
    """The EFFECTIVE drop rate of dropout_keep_mask: on the uint8 path
    the requested rate rounds to threshold/256."""
    if exact or rate <= 0.0:
        return rate
    if rate >= 1.0:
        return 1.0
    return min(int(round(rate * 256.0)), 255) / 256.0


def dropout_keep_mask(generator: Optional[torch.Generator], shape, rate: float,
                      exact: bool = False, device="cuda") -> torch.Tensor:
    """Boolean keep-mask on ``device``: True with probability 1 -
    quantized_rate(rate). ``exact=False`` compares uint8 bits with
    round(rate * 256); ``exact=True`` draws bernoulli(1 - rate).
    ``generator`` must live on ``device``."""
    if exact:
        keep = torch.full(shape, 1.0 - rate, device=device)
        return torch.bernoulli(keep, generator=generator).bool()
    if rate >= 1.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    threshold = int(round(rate * 256.0))
    if threshold <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    bits = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=generator)
    return bits >= min(threshold, 255)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            exact: bool = False) -> torch.Tensor:
    """Inverted dropout of ``x``, scaled by the EFFECTIVE keep
    probability so E[output] == input on the quantized path too."""
    if rate <= 0.0:
        return x
    keep = dropout_keep_mask(generator, x.shape, rate, exact=exact,
                             device=x.device)
    eff = quantized_rate(rate, exact)
    if eff >= 1.0:
        return torch.zeros_like(x)
    return torch.where(keep, x / (1.0 - eff), 0.0).to(x.dtype)


class Dropout(nn.Module):
    """Counterpart of tpudl.ops.dropout.Dropout: identity unless
    ``deterministic`` is False, then ``dropout`` with the given
    generator (the flax "dropout" rng collection)."""

    def __init__(self, rate: float, exact: bool = False):
        super().__init__()
        self.rate = rate
        self.exact = exact

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        if deterministic or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError(
                "dropout in training needs a torch.Generator (the JAX "
                "package's 'dropout' rng)"
            )
        return dropout(generator, x, self.rate, self.exact)
