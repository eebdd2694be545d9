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
  uses it unrounded and only the stored copy is cast to its dtype
  (``mu_dtype``, or a precision policy's per-leaf moment dtype);
  ``eps`` is added outside the square root; weight decay applies to
  every parameter; the step is
  ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
- SGD: ``add_decayed_weights`` then Nesterov ``trace`` and the
  learning rate;
- the schedule reads the step count before it is incremented.

The update reads nothing from the host, so a CUDA graph can capture it
(tpudl_torch.train.loop.compile_step): the state's ``count`` is a 0-d
int64 tensor on the parameters' device, advanced in place, and the
step's learning rate and bias corrections are the f32 device tensor
``scalars``, which ``prepare_`` fills from the host count (the same f32
host math as before) ahead of each update. ``apply_`` is ``prepare_``,
``update_`` (the device work) and ``advance_`` (the host count), so the
eager update and a replayed one run the same operations on the same
values. ``host_count`` mirrors ``count`` on the host.

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
        #: The first moment's dtype where ``init`` is not told otherwise.
        self.mu_dtype = _DTYPES[cfg.mu_dtype]

    def init(self, params: Dict[str, torch.Tensor],
             mu_dtypes: Optional[Dict[str, torch.dtype]] = None) -> dict:
        """The state for ``params``: zero moments (or traces), ``count``
        0. ``mu_dtypes`` (name -> dtype, e.g. a precision policy's
        ``moment_dtypes``) stores those leaves' first moments in another
        dtype than ``cfg.mu_dtype``; the update reads each moment's
        dtype from the moment itself."""
        mu_dtypes = mu_dtypes or {}
        zeros = lambda p, dtype=None: torch.zeros_like(  # noqa: E731
            p, dtype=dtype, memory_format=torch.contiguous_format)
        device = next(iter(params.values())).device if params else "cpu"
        state = {
            "count": torch.zeros((), dtype=torch.int64, device=device),
            "host_count": 0,
            # lr, then (AdamW) the two bias corrections of the next update.
            "scalars": torch.zeros(1 if self.cfg.name == "sgd" else 3,
                                   dtype=torch.float32, device=device),
        }
        if self.cfg.name == "sgd":
            state["trace"] = {k: zeros(p) for k, p in params.items()}
        else:
            state["mu"] = {k: zeros(p, mu_dtypes.get(k, self.mu_dtype))
                           for k, p in params.items()}
            state["nu"] = {k: zeros(p) for k, p in params.items()}
        return state

    def host_scalars(self, count: int) -> list:
        """The f32 learning rate (and AdamW's bias corrections, which optax
        computes in f32) of the update that reads ``count``."""
        lr = float(np.float32(self.schedule(count)))
        if self.cfg.name == "sgd":
            return [lr]
        t = np.float32(count + 1)
        return [lr, float(1 - np.float32(self.cfg.b1) ** t),
                float(1 - np.float32(self.cfg.b2) ** t)]

    def prepare_(self, state: dict) -> None:
        """Fill ``state["scalars"]`` for the next update. Skipped while a
        CUDA graph captures (the caller fills them before each replay)."""
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            return
        values = torch.tensor(self.host_scalars(state["host_count"]),
                              dtype=torch.float32)
        # Pageable memory, staged by CUDA before the call returns: no wait
        # for the card.
        state["scalars"].copy_(values, non_blocking=True)

    @staticmethod
    def advance_(state: dict) -> None:
        """The host half of one update: the count's host mirror."""
        state["host_count"] += 1

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

    def apply_(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict) -> dict:
        """One update of ``params`` in place; returns ``state``, advanced
        in place."""
        self.prepare_(state)
        self.update_(params, grads, state)
        self.advance_(state)
        return state

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: dict,
                ok: Optional[torch.Tensor] = None) -> None:
        """The device half of one update: reads ``state["scalars"]``,
        moves the parameters, the moments and ``count`` in place. ``ok``
        (a device bool, a precision policy's finite flag) gates it: where
        it is False the parameters, the moments and ``count`` keep their
        values bit for bit (a ``torch.where`` per tensor, no host
        branch)."""
        cfg = self.cfg
        grads = self.clip(grads)
        wd = cfg.weight_decay
        neg_lr = -state["scalars"][0]

        def commit(t, new):
            t.copy_(new if ok is None else torch.where(ok, new, t))

        if ok is None:
            state["count"].add_(1)
        else:
            state["count"].add_(ok.to(state["count"].dtype))
        if cfg.name == "sgd":
            for k, p in params.items():
                g = grads[k] + wd * p
                trace = state["trace"][k]
                if ok is None:
                    trace.mul_(cfg.momentum).add_(g)
                    p.add_((g + cfg.momentum * trace) * neg_lr)
                    continue
                new_trace = trace * cfg.momentum + g
                commit(p, p + (g + cfg.momentum * new_trace) * neg_lr)
                commit(trace, new_trace)
            return
        b1, b2 = cfg.b1, cfg.b2
        bc1, bc2 = state["scalars"][1], state["scalars"][2]
        # optax multiplies the stored moment by b1 in the moment's dtype:
        # with a bf16 moment b1 itself rounds to bf16 (0.9 -> 0.8984375),
        # and the compiled step keeps the product in f32. The bias
        # correction uses b1 as given.
        b1_mu = {dt: float(torch.tensor(b1, dtype=dt))
                 for dt in {m.dtype for m in state["mu"].values()}}
        for k, p in params.items():
            g = grads[k]
            stored = state["mu"][k]
            mu = (1 - b1) * g + b1_mu[stored.dtype] * stored.float()
            nu = state["nu"][k]
            if ok is None:
                nu.mul_(b2).add_((1 - b2) * (g * g))
                new_nu = nu
            else:
                new_nu = nu * b2 + (1 - b2) * (g * g)
            update = (mu / bc1) / (torch.sqrt(new_nu / bc2) + 1e-8)
            update = (update + wd * p) * neg_lr
            if ok is None:
                p.add_(update)
            else:
                commit(p, p + update)
                commit(nu, new_nu)
            commit(stored, mu)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    return Optimizer(cfg)
