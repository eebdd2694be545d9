"""Optimizer and schedule construction from OptimConfig: the port's
counterpart of tpudl.train.optim, written by hand to follow optax.

``make_optimizer`` returns an ``Optimizer``: ``init(params)`` makes its
state, ``apply_(params, grads, state)`` updates the parameters IN PLACE
(no copy of the parameters per step) and returns the advanced state.
The update is optax's chain, in optax's order and dtypes:

- ``clip_by_global_norm(max)``: ``t`` when ``||g|| < max``, else
  ``t / ||g|| * max`` (no epsilon; not ``clip_grad_norm_``);
- AdamW (``scale_by_adam`` + ``add_decayed_weights`` +
  ``scale_by_learning_rate``): the new first moment is computed in f32
  from the stored one (as tpudl's compiled step computes it), the update
  uses it unrounded and only the stored copy is cast to ``mu_dtype``;
  ``eps`` is added outside the square root; weight decay applies to
  every parameter; the step is
  ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
- SGD: ``add_decayed_weights`` then Nesterov ``trace`` and the
  learning rate;
- the schedule reads the step count before it is incremented.

``torch.optim.AdamW`` cannot hold the first moment in bf16 and rounds
at other places, so it is not used.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpudl_torch.config import OptimConfig

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule (alpha 0, exponent 1)."""

    def schedule(count):
        count = min(count, decay_steps)
        return init_value * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """optax.join_schedules: past each boundary, the next schedule of
    the count since that boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(cfg: OptimConfig) -> Schedule:
    if cfg.schedule == "constant":
        sched = constant_schedule(cfg.learning_rate)
    elif cfg.schedule == "linear":
        sched = linear_schedule(
            cfg.learning_rate, 0.0, max(cfg.total_steps - cfg.warmup_steps, 1)
        )
    else:
        sched = cosine_decay_schedule(
            cfg.learning_rate, max(cfg.total_steps - cfg.warmup_steps, 1)
        )
    if cfg.warmup_steps > 0:
        warmup = linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps)
        sched = join_schedules([warmup, sched], [cfg.warmup_steps])
    return sched


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Optimizer:
    """The update ``make_optimizer`` builds; see the module docstring.
    ``params`` and ``grads`` are dicts of name -> tensor (f32
    masters)."""

    def __init__(self, cfg: OptimConfig):
        if cfg.name not in ("adamw", "sgd"):
            raise ValueError(f"optimizer must be 'adamw' or 'sgd', got {cfg.name!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = _DTYPES[cfg.mu_dtype]

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda p, dtype=None: torch.zeros_like(  # noqa: E731
            p, dtype=dtype, memory_format=torch.contiguous_format)
        if self.cfg.name == "sgd":
            return {"count": 0, "trace": {k: zeros(p) for k, p in params.items()}}
        return {
            "count": 0,
            "mu": {k: zeros(p, self.mu_dtype) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
        }

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """optax.clip_by_global_norm(cfg.grad_clip_norm), without a host
        sync (the choice is a ``torch.where`` on the device)."""
        max_norm = self.cfg.grad_clip_norm
        if not max_norm:
            return grads
        norms = torch._foreach_norm(list(grads.values()))
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        keep = g_norm < max_norm
        return {k: torch.where(keep, g, g / g_norm * max_norm)
                for k, g in grads.items()}

    @torch.no_grad()
    def apply_(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict) -> dict:
        cfg = self.cfg
        grads = self.clip(grads)
        count = state["count"]
        lr = float(np.float32(self.schedule(count)))
        wd = cfg.weight_decay
        if cfg.name == "sgd":
            for k, p in params.items():
                g = grads[k] + wd * p
                trace = state["trace"][k]
                trace.mul_(cfg.momentum).add_(g)
                p.add_((g + cfg.momentum * trace) * -lr)
            return {"count": count + 1, "trace": state["trace"]}
        b1, b2 = cfg.b1, cfg.b2
        # optax multiplies the stored moment by b1 in the moment's dtype:
        # with a bf16 moment b1 itself rounds to bf16 (0.9 -> 0.8984375),
        # and the compiled step keeps the product in f32. The bias
        # correction uses b1 as given.
        b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
        t = count + 1
        # optax computes the bias corrections in f32.
        bc1 = float(1 - np.float32(b1) ** np.float32(t))
        bc2 = float(1 - np.float32(b2) ** np.float32(t))
        for k, p in params.items():
            g = grads[k]
            mu = (1 - b1) * g + b1_mu * state["mu"][k].float()
            nu = state["nu"][k]
            nu.mul_(b2).add_((1 - b2) * (g * g))
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
            update = (update + wd * p) * -lr
            p.add_(update)
            state["mu"][k].copy_(mu)
        return {"count": t, "mu": state["mu"], "nu": state["nu"]}


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)
