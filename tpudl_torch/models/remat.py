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

A captured step (tpudl_torch.train.loop.compile_step) cannot do that:
``get_state`` / ``set_state`` are host reads and writes of a state the
graph advances on the card. There the recompute draws from a twin
generator instead, one per segment, registered with the capture: the
eager warm-up step records each segment's generator and its offset at
the segment's start (``recording``), the capture gives the k-th
segment's recompute the k-th twin (``capturing``; the generator swaps to
the twin's state with ``graphsafe_set_state`` for the recompute and
back), and before every replay each twin is set to its generator's seed
at the recorded offset (``CaptureTwins.prepare``). The recompute then
draws, bit for bit, what the forward drew.

``policy="dots_saveable"`` is jax's policy of that name: the matrix
products' outputs are saved and everything else is recomputed (selective
activation checkpointing); None saves nothing.

An fp8 site (tpudl_torch.ops.fp8_dot.Fp8Dense) recomputed in the
backward quantizes with the same scales (its rings move only after the
step's update) and so gives the same bits, and its amax observations
combine by max, so the recompute records nothing twice.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
#: The matrix products, as the autograd dispatcher sees them (F.linear
#: and torch.matmul decompose into these; the fp8 sites' products are
#: ``_scaled_mm`` on the card, tpudl's fp8 dot_general).
DOTS = frozenset((_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
                  _aten.baddbmm.default, _aten._scaled_mm.default))
POLICIES = (None, "dots_saveable")


def _save_dots(ctx, op, *args, **kwargs):
    if op in DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def check_policy(policy: Optional[str]) -> None:
    if policy not in POLICIES:
        raise ValueError(f"remat_policy must be one of {POLICIES}, got "
                         f"{policy!r}")


#: Set while an eager step records its segments (``recording``): the
#: (generator, offset at the segment's start) of each segment in order.
_recorded: Optional[List[Tuple[torch.Generator, int]]] = None
#: Set while a step is captured (``capturing``).
_twins: Optional["CaptureTwins"] = None


@contextlib.contextmanager
def recording():
    """Record the segments the enclosed (eager) step runs: yields the
    list of ``(generator, offset)`` pairs it fills."""
    global _recorded
    _recorded, outer = [], _recorded
    try:
        yield _recorded
    finally:
        _recorded = outer


class CaptureTwins:
    """The recompute twins of a captured step: ``plan`` is the recorded
    ``(generator position, offset)`` of each segment, the position
    indexing ``generators`` (the step's generators, reseeded before each
    replay). ``generators`` + ``twins`` are what the capture registers."""

    def __init__(self, plan: Sequence[Tuple[int, int]],
                 generators: Sequence[torch.Generator]):
        self.plan = list(plan)
        self.generators = list(generators)
        self.twins = [torch.Generator(device=generators[j].device)
                      for j, _ in self.plan]
        self.next = 0

    def take(self, generator: torch.Generator) -> torch.Generator:
        """The twin of the next segment, which must draw from the
        generator the eager step's segment drew from."""
        k = self.next
        if k >= len(self.plan) or \
                self.generators[self.plan[k][0]] is not generator:
            raise RuntimeError(
                f"remat segment {k} of the capture does not match the eager "
                f"step's segments ({len(self.plan)} recorded): a captured "
                f"remat step must run the segments its warm-up ran")
        self.next += 1
        return self.twins[k]

    def prepare(self, seeds: Sequence[int]) -> None:
        """Before a replay: each twin at its generator's seed (``seeds``,
        in the generators' order) and its segment's offset."""
        for twin, (j, offset) in zip(self.twins, self.plan):
            twin.manual_seed(seeds[j])
            twin.set_offset(offset)


@contextlib.contextmanager
def capturing(twins: CaptureTwins):
    """Give each segment of the enclosed capture its twin."""
    global _twins
    _twins, outer = twins, _twins
    twins.next = 0
    try:
        yield
    finally:
        _twins = outer
    if twins.next != len(twins.plan):
        raise RuntimeError(
            f"the capture ran {twins.next} remat segments, the eager step "
            f"{len(twins.plan)}")


def _twin_run(fn, generator, twin):
    calls = []

    def run(*a):
        if not calls:
            calls.append(1)
            return fn(*a)
        current = generator.graphsafe_get_state()
        generator.graphsafe_set_state(twin)
        try:
            return fn(*a)
        finally:
            generator.graphsafe_set_state(current)

    return run


def checkpointed(fn: Callable, generator: Optional[torch.Generator], *args,
                 policy: Optional[str] = None):
    check_policy(policy)
    run = fn
    if generator is not None and _twins is not None:
        run = _twin_run(fn, generator, _twins.take(generator))
    elif generator is not None:
        if _recorded is not None:
            _recorded.append((generator, generator.get_offset()))
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
