"""Rematerialization: the port's counterpart of flax ``nn.remat``
(``jax.checkpoint``) for the BERT and Llama training forwards.

``checkpointed(fn, generator, *args, policy=None)`` runs ``fn(*args)``
under ``torch.utils.checkpoint`` with ``use_reentrant=False``: the
backward recomputes the segment's forward instead of keeping its
activations. Non-reentrant checkpointing records the usual autograd graph
and only drops the saved tensors, so a segment whose inputs need no
gradient (a frozen Llama base under LoRA) still gives its parameters
theirs, and the backward accumulates in the same order as without remat.

The recompute must draw the bits the forward drew. ``checkpoint``
restores only the global RNG states, while every dropout mask and every
kernel's Philox seed words come from the step's explicit
``torch.Generator``: the segment records that generator's state when it
first runs, sets it back before the recompute, and afterwards returns it
to the state the recompute found. With deterministic kernels the
recomputed activations, and so the gradients, are bitwise those of the
forward without remat. The recompute launches the segment's kernels a
second time.

``policy="dots_saveable"`` is jax's policy of that name: the matrix
products' outputs are saved and everything else is recomputed (selective
activation checkpointing); None saves nothing.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
#: The matrix products, as the autograd dispatcher sees them (F.linear
#: and torch.matmul decompose into these).
DOTS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                  _aten.baddbmm.default))
POLICIES = (None, "dots_saveable")


def _save_dots(ctx, op, *args, **kwargs):
    if op in DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES}, got "
                         f"{policy!r}")


def checkpointed(fn: Callable, generator: Optional[torch.Generator], *args,
                 policy: Optional[str] = None):
    check_policy(policy)
    run = fn
    if generator is not None:
        start = generator.get_state()
        calls = []

        def run(*a):
            if not calls:
                calls.append(1)
                return fn(*a)
            found = generator.get_state()
            generator.set_state(start)
            try:
                return fn(*a)
            finally:
                generator.set_state(found)

    kw = {}
    if policy == "dots_saveable":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # Every draw is from ``generator``; the global states play no part.
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)
