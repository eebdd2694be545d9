"""Mixture-of-experts FFN: the port's counterpart of tpudl.ops.moe.

Routing is dense one-hot algebra (GShard / Switch), as tpudl's: no
gather, no scatter, no data-dependent shapes.

- router probabilities ``p = softmax(x @ w_r)`` in f32;
- the k choices are peeled off one at a time (argmax, the first index on
  ties in both packages; mask; the next argmax), earlier choices taking
  dispatch priority;
- ``position_in_expert`` is a cumsum over the token axis; a token past
  its expert's capacity ``C = ceil(k * S * capacity_factor / E)`` is
  dropped (combine weight zero: the caller's residual carries it);
- gate values are normalised by the full top-k gate sum (GShard), so a
  dropped choice's mass shrinks the survivors' weights;
- the Switch load-balance loss ``E * sum_e f_e * p_e`` (f = top-1
  dispatch fraction, p = mean router probability).

The dispatch and combine are ``torch.einsum`` contractions, as tpudl's
are XLA contractions (no Pallas kernel). tpudl's ``constrain`` places
the expert axis on its ``ep`` mesh axis; the port runs on one card and
has no mesh, so it is left out. ``EP_MOE_RULES`` and ``with_moe_rules``
are kept as data: placing parameters by rules waits for sharding
(tpudl_torch.rules.match_partition_rules raises, naming ROADMAP queue A
item 7).

flax's ``sow`` has no PyTorch counterpart: ``MoEMlp.forward`` returns
the output and records its aux loss on the module (``aux_loss``, the
tensor of the last forward, in the autograd graph), and
``take_moe_aux_losses(model)`` collects (and clears) them for the train
step
(tpudl_torch.train.loop ``moe_aux_weight``). No global state.
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch
import torch.nn.functional as F
from torch import nn

#: Placement rules of tpudl's MoE parameters (partition specs as tuples
#: of mesh axis names): the expert axis over ``ep``, then the usual
#: column / row split. Data only on one card.
EP_MOE_RULES = (
    (r"(^|/)router/kernel$", (None, None)),
    (r"(^|/)(wi|wg)$", ("ep", "fsdp", "tp")),
    (r"(^|/)wo$", ("ep", "tp", "fsdp")),
)


def with_moe_rules(base) -> tuple:
    """Prepend the MoE expert rules to a base rule list (first match wins,
    so expert parameters resolve before the generic kernel rules)."""
    return tuple(EP_MOE_RULES) + tuple(base or ())


def expert_capacity(seq_len: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    return max(1, math.ceil(k * seq_len * capacity_factor / num_experts))


def route_topk(probs: torch.Tensor, k: int, capacity: int):
    """Dispatch and combine tensors from router probabilities ``probs``
    ``[G, S, E]`` (f32, softmax over E): ``(dispatch [G, S, E, C] 0/1,
    combine [G, S, E, C], aux)`` in ``probs``' dtype."""
    g, s, e = probs.shape
    dt = probs.dtype
    top1_mask = F.one_hot(probs.argmax(-1), e).to(dt)
    slots = torch.arange(capacity, device=probs.device)

    remaining = probs
    counts = probs.new_zeros((g, 1, e))
    dispatch = probs.new_zeros((g, s, e, capacity))
    combine = probs.new_zeros((g, s, e, capacity))
    gate_total = probs.new_zeros((g, s))
    for _ in range(k):
        idx = remaining.argmax(-1)                       # [G, S]
        gate = remaining.amax(-1)                        # [G, S]
        mask = F.one_hot(idx, e).to(dt)                  # [G, S, E]
        # 0-based slot of each token within its expert, counting the
        # earlier choices' kept assignments first.
        pos = torch.cumsum(mask, dim=1) - mask + counts  # [G, S, E]
        keep = (pos < capacity).to(dt) * mask
        counts = counts + keep.sum(1, keepdim=True)
        # jax.nn.one_hot: an index past the capacity is an all-zero row.
        slot = ((pos * mask).sum(-1).long()[..., None] == slots).to(dt)
        disp = keep[..., None] * slot[:, :, None, :]     # [G, S, E, C]
        dispatch = dispatch + disp
        combine = combine + disp * gate[..., None, None]
        gate_total = gate_total + gate
        remaining = remaining * (1.0 - mask)
    combine = combine / gate_total.clamp_min(1e-9)[..., None, None]
    f = top1_mask.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    aux = e * (f * p).sum()
    return dispatch, combine, aux


def _silu(x):
    """jax.nn.silu as it is defined: ``x * sigmoid(x)``."""
    return x * torch.sigmoid(x)


class MoEMlp(nn.Module):
    """Expert FFN block, a drop-in for a dense MLP of the same hidden and
    intermediate sizes (the caller keeps its residual, so dropped tokens
    pass through). ``gated=True`` is the SwiGLU variant (Llama's), else
    ``act(x @ wi) @ wo``. Parameters in tpudl's layout: ``router.weight``
    ``[E, M]`` (tpudl's ``router/kernel`` transposed, f32), ``wi`` / ``wg``
    ``[E, M, H]`` and ``wo`` ``[E, H, M]`` in ``param_dtype`` (f32 masters
    in training, cast to ``dtype`` at use)."""

    def __init__(self, hidden_size: int, num_experts: int,
                 intermediate_size: int, k: int = 2,
                 capacity_factor: float = 1.25, gated: bool = False,
                 act: Callable = None, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.gated, self.dtype = gated, dtype
        self.act = act if act is not None else (
            _silu if gated else (lambda v: F.gelu(v, approximate="tanh")))
        e, m, h = num_experts, hidden_size, intermediate_size
        self.router = nn.Linear(m, e, bias=False, device=device,
                                dtype=torch.float32)

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=param_dtype,
                                            device=device))

        self.wi = param(e, m, h)
        self.wg = param(e, m, h) if gated else None
        self.wo = param(e, h, m)
        self.aux_loss = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.shape[1]
        cap = expert_capacity(s, self.num_experts, self.k,
                              self.capacity_factor)
        # Router in f32: routing decisions are precision-sensitive.
        logits = F.linear(x.float(), self.router.weight.float())
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, aux = route_topk(probs, self.k, cap)
        self.aux_loss = aux
        dt = self.dtype
        x = x.to(dt)
        xin = torch.einsum("gsec,gsm->egcm", dispatch.to(dt), x)
        hh = torch.einsum("egcm,emh->egch", xin, self.wi.to(dt))
        if self.gated:
            hh = self.act(hh) * torch.einsum("egcm,emh->egch", xin,
                                             self.wg.to(dt))
        else:
            hh = self.act(hh)
        out = torch.einsum("egch,ehm->egcm", hh, self.wo.to(dt))
        return torch.einsum("gsec,egcm->gsm", combine.to(dt), out)


def take_moe_aux_losses(model: nn.Module) -> List[torch.Tensor]:
    """The aux losses the model's MoE layers recorded in their last
    forward (tpudl's sown ``moe_aux_loss`` entries), in module order; each
    layer's record is cleared, since it holds its forward's autograd
    graph, which a CUDA-graph capture of the next step must not find
    alive."""
    out = []
    for m in model.modules():
        if isinstance(m, MoEMlp) and m.aux_loss is not None:
            out.append(m.aux_loss)
            m.aux_loss = None
    return out
