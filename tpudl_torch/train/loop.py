"""The classification train step and loop: the port's counterpart of the
single-device path of tpudl.train.loop.

- ``TrainState`` holds the model (its parameters are the f32 masters),
  the optimizer, its state and the step count. Unlike JAX, a step
  updates the parameters and the optimizer state IN PLACE (no copy of
  the state per step) and returns the same object. Its ``params`` are
  the trainable parameters only (``requires_grad``): a frozen base
  (tpudl_torch.models.lora) gets no gradient, no zeros in their place
  and no optimizer state.
- ``TrainState.batch_stats`` is a view of the model's BatchNorm running
  statistics (tpudl's ``state.batch_stats``), None for a model without
  BatchNorm. A train forward moves them in place.
- ``make_classification_train_step`` builds ``step(state, batch, rng)``:
  forward with ``train=True``, mean cross-entropy, backward, one
  optimizer update. ``rng`` is an int seed; the step's dropout masks
  come from ``fold_in(rng, state.step)``, so every step draws fresh bits
  (tpudl's ``fold_in(rng, state.step)``). With ``accum_steps=A`` the
  batch splits into A microbatches (``microbatch``); microbatch ``a``
  draws from ``fold_in(fold_seed(rng, state.step), a)`` (tpudl's
  ``fold_in(step_rng, a)``), each backward adds into the parameters'
  ``.grad``, the BatchNorm statistics move microbatch by microbatch, and
  the summed gradients and metrics are divided by A before the one
  update. ``step.seeds(state, rng)`` gives the step's generator seeds,
  and ``step(state, batch, rng, generators=...)`` draws from the given
  generators (seeded so) instead of fresh ones: what ``compile_step``
  replays.
- ``make_classification_eval_step`` builds ``step(state, batch)``: the
  forward with ``train=False`` and no autograd, the per-example loss and
  the accuracy as means (masked means over the real rows when the batch
  has a ``"_valid"`` column); it carries the ``mask_aware`` marker.
- ``pad_batch`` and ``evaluate``: a ragged eval tail padded with a
  ``"_valid"`` mask for a mask-aware step, and the metrics weighted by
  each batch's real rows.
- ``loss_impl`` routes the per-example loss through
  tpudl_torch.ops.cross_entropy: "reference" is the composite the step
  always used; "auto" / "fused" the vocab-streaming kernels on the card.
- ``compile_step`` is tpudl's ``compile_step`` as CUDA-graph capture
  (tpudl_torch.graphs): on a CUDA state the first call runs eagerly, the
  second captures the whole step (every microbatch, the update, the
  BatchNorm statistics) and replays it, and every later call copies the
  batch into the graph's input buffers, reseeds its generators and
  replays; a remat model's recomputes draw from twin generators the
  capture registers (tpudl_torch.models.remat). On a CPU state it runs
  the step eagerly.
- ``fit`` drives a step (eager or compiled) over a batch iterator, one
  step per dispatch, with tpudl's checkpoint cadence, preemption check
  and end-of-fit (emergency) save through a checkpoint manager
  (tpudl_torch.checkpoint, tpudl_torch.ft), tpudl's spans and
  histograms when a span recorder is active (tpudl_torch.obs; read by
  tpudl_torch.obs.goodput), and tpudl's profiler window
  (``profile_dir``: a torch.profiler Chrome trace that
  tpudl_torch.train.profiling reads); ``resume_latest`` and
  ``finalize_zero_step_run`` are tpudl's resume helpers.
- ``precision=`` (a tpudl_torch.train.precision policy or preset name;
  None keeps the step exactly as without one) on
  ``create_train_state``, ``make_classification_train_step`` and
  ``compile_step``: the rule-matched parameters cast to the compute
  dtype for the forward (``torch.func.functional_call``; f32 masters,
  f32 gradients), logits cast to the reduce dtype before the loss, the
  objective multiplied by the loss scale and the gradients divided by it
  per microbatch, before clipping. ``ok`` (all gradients finite, on the
  device) gates the update: a skipped step leaves the parameters, the
  optimizer state (``count`` included) and the BatchNorm statistics
  bitwise as they were, backs the scale off, and advances no fp8 ring
  (tpudl_torch.ops.fp8_dot). The host's counts (``state.step``,
  ``host_count``, and so the next step's generator seeds) advance only
  on a step that was not skipped: under a loss-scaling policy the step
  reads ``ok`` back (one byte) after the update, eager or replayed, so
  the next step draws the masks the skipped one drew, as tpudl's skip
  (one select over the whole state, ``step`` included) makes it do. The
  metrics gain ``loss_scale`` (the scale the step used) and
  ``grad_skipped``. ``TrainState.precision`` holds the loss-scale state
  and the model's fp8 rings (a view in tpudl's layout, like
  ``batch_stats``); checkpoints carry it.

``moe_aux_weight`` > 0 adds ``weight * sum`` of the load-balance losses
the model's MoE layers recorded in the forward
(tpudl_torch.ops.moe.take_moe_aux_losses, tpudl's sown ``moe_aux_loss``) to
the loss, and reports the sum as the ``moe_aux`` metric; ``loss`` then
includes the term, as tpudl's.

Not ported (each raises NotImplementedError naming its ROADMAP item):
meshes; and fit's fused K-step dispatch and asynchronous metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import os
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from tpudl_torch.analysis.registry import env_str
from tpudl_torch.ft import preemption as ft_preemption
from tpudl_torch.graphs import Graph, StaticInputs
from tpudl_torch.models import remat
from tpudl_torch.models.resnet import BatchNorm
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import exporter as obs_exporter
from tpudl_torch.obs import spans as obs_spans
from tpudl_torch.ops.cross_entropy import softmax_cross_entropy
from tpudl_torch.ops.moe import take_moe_aux_losses
from tpudl_torch.ops.fp8_dot import (
    advance_rings,
    fp8_state,
    reset_fp8_state,
    zero_observations,
)
from tpudl_torch.rng import fold_seed
from tpudl_torch.rules import path_str
from tpudl_torch.train import precision as precision_mod
from tpudl_torch.train.optim import Optimizer
from tpudl_torch.train.profiling import STEP_ANNOTATION, trace_path


def microbatch(batch: dict, accum_steps: int) -> dict:
    """Split the [B, ...] columns of ``batch`` (arrays or tensors) into
    [A, B/A, ...] microbatches: microbatch ``a`` is rows [a B/A, (a + 1)
    B/A). tpudl's split over one batch shard, a plain reshape."""

    def one(x):
        b = x.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps} x batch shards 1")
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

    return {k: one(v) for k, v in batch.items()}


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: Optimizer
    opt_state: dict
    step: int = 0
    #: The memory pool the state's captured steps share (compile_step).
    graph_pool: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    #: A precision policy's state (``create_train_state(precision=)``):
    #: ``{"loss_scale": {...}, "fp8": the model's rings}``, or None.
    precision: Optional[dict] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The trainable parameters, by state_dict name."""
        return {k: p for k, p in self.model.named_parameters()
                if p.requires_grad}

    @property
    def batch_stats(self) -> Optional[Dict[str, torch.Tensor]]:
        """The BatchNorm running statistics by state_dict name (the
        model's buffers themselves), or None without BatchNorm."""
        stats = {f"{name}.{leaf}": getattr(m, leaf)
                 for name, m in self.model.named_modules()
                 if isinstance(m, BatchNorm) for leaf in ("mean", "var")}
        return stats or None

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> "TrainState":
        """One optimizer update of the parameters, in place."""
        self.opt_state = self.tx.apply_(self.params, grads, self.opt_state)
        self.step += 1
        return self


def tpudl_path(model: nn.Module) -> Callable[[str], str]:
    """The model's parameter name -> tpudl tree path map (its inverse
    weight bridge, ``model.tpudl_path``), for the precision rules."""
    return getattr(model, "tpudl_path", path_str)


def create_train_state(
    rng,
    model: nn.Module,
    tx: Optimizer,
    params: Optional[Dict[str, torch.Tensor]] = None,
    device="cuda",
    precision=None,
) -> TrainState:
    """Put ``model`` on ``device`` and give it its starting weights: drawn
    by ``model.init_weights`` from ``rng`` (an int seed, or a
    ``torch.Generator`` on ``device``), or copied from ``params`` (a
    state_dict, e.g. from ``params_from_tpudl``). The optimizer state
    starts at zero, and the fp8 rings of an ``fp8_train`` model at zero.

    ``precision`` (a tpudl_torch.train.precision policy or preset name)
    stores each first moment in the dtype the policy's moment rules
    select and seeds ``state.precision`` (the loss-scale state, and the
    model's fp8 rings when the policy routes products through fp8). None
    is exactly the state without a policy."""
    device = torch.device(device)
    if any(p.device != device for p in model.parameters()):
        model.to_empty(device=device)
    if params is not None:
        model.load_state_dict(params, strict=True)
    else:
        gen = rng
        if not isinstance(rng, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(rng))
        model.init_weights(gen)
    # The rings are not in the state_dict (to_empty leaves them unset).
    reset_fp8_state(model)
    model.train()
    state = TrainState(model=model, tx=tx, opt_state={})
    pol = precision_mod.resolve_policy(precision)
    mu_dtypes = None if pol is None else pol.moment_dtypes(
        state.params, tpudl_path(model))
    state.opt_state = tx.init(state.params, mu_dtypes=mu_dtypes)
    state.precision = precision_mod.init_precision_state(
        pol, fp8_state(model), device)
    return state


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    impl: str = "reference",
) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, in f32, through the
    tpudl_torch.ops.cross_entropy seam: ``impl="reference"`` is the optax
    composite tpudl's reference computes (label smoothing as
    ``optax.smooth_labels``); "auto" / "fused" stream the vocabulary
    through the kernels on the card (see ``softmax_cross_entropy``)."""
    return softmax_cross_entropy(logits, labels, label_smoothing,
                                 impl=impl).mean()


def _refuse(option: str, value, item: str) -> None:
    raise NotImplementedError(
        f"{option}={value!r} is not ported to tpudl_torch yet (ROADMAP {item})"
    )


def make_classification_train_step(
    label_smoothing: float = 0.0,
    input_keys: "str | tuple" = ("image",),
    label_key: str = "label",
    moe_aux_weight: float = 0.0,
    accum_steps: int = 1,
    input_transform: Optional[Callable[[dict], dict]] = None,
    loss_impl: str = "reference",
    precision=None,
) -> Callable:
    """Train step for classification models: ``step(state, batch, rng)
    -> (state, metrics)`` with ``metrics`` = ``{"loss", "accuracy"}``
    as 0-d tensors on the device (reading them waits for the step).

    ``input_keys`` name the batch columns passed positionally to the
    model — ``("input_ids", "attention_mask")`` for BERT. The batch may
    hold numpy arrays or tensors; they go to the model's device first,
    then (per microbatch) through ``input_transform``. ``loss_impl``: see
    the module docstring. ``accum_steps`` > 1 splits the batch into that
    many microbatches, run in order with one optimizer update (see the
    module docstring): equal to the monolithic step, up to summation
    order, for a model whose loss is a mean over examples and which has
    no BatchNorm. ``precision``: the mixed-precision policy (module
    docstring); under loss scaling the metrics gain ``loss_scale`` and
    ``grad_skipped``, and ``loss`` stays the unscaled loss.
    ``step.grads_and_metrics(state, batch, generator)`` is the step
    without the optimizer update (the gradients of the trainable
    parameters as a dict of tensors, unscaled), for checks; under
    accumulation ``generator`` is a sequence of one generator per
    microbatch."""
    if isinstance(input_keys, str):
        input_keys = (input_keys,)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    policy = precision_mod.resolve_policy(precision)
    scaling = policy is not None and policy.loss_scale is not None
    use_fp8 = policy is not None and policy.use_fp8
    # model -> the names of the parameters the policy casts.
    cast_names: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def forward(model: nn.Module, inputs, generator):
        if policy is None:
            return model(*inputs, train=True, generator=generator)
        params = dict(model.named_parameters())
        if model not in cast_names:
            cast = policy.cast_params(params, tpudl_path(model))
            cast_names[model] = [k for k, v in cast.items()
                                 if v is not params[k]]
        cast = {k: params[k].to(policy.compute_dtype)
                for k in cast_names[model]}
        if cast:
            # A remat segment recomputes outside the call, on the masters:
            # the models cast each projection at use, so it computes the
            # same values (the rules cast nothing else inside one).
            logits = torch.func.functional_call(
                model, cast, inputs, {"train": True, "generator": generator},
                strict=False)
        else:
            logits = model(*inputs, train=True, generator=generator)
        # The reduce dtype: the loss never runs in the compute dtype.
        return logits.to(policy.reduce_dtype)

    def backward(state: TrainState, batch: dict, generator, scale):
        """Forward and backward of one (micro)batch already on the
        device; the backward adds into the parameters' ``.grad`` (the
        gradient of ``loss * scale`` under loss scaling). Returns the
        metrics as means over its rows."""
        if input_transform is not None:
            batch = input_transform(batch)
        logits = forward(state.model, tuple(batch[k] for k in input_keys),
                         generator)
        labels = batch[label_key].long()
        loss = cross_entropy_loss(logits, labels, label_smoothing,
                                  impl=loss_impl)
        # The load-balance losses the forward's MoE layers recorded
        # (tpudl's sown moe_aux_loss entries), taken off the model always.
        aux_losses = take_moe_aux_losses(state.model)
        aux = None
        if moe_aux_weight > 0.0:
            aux = sum(aux_losses, logits.new_zeros(()))
            loss = loss + moe_aux_weight * aux
        (loss if scale is None else loss * scale).backward()
        metrics = {
            "loss": loss.detach(),
            "accuracy": (logits.detach().argmax(-1) == labels).float().mean(),
        }
        if aux is not None:
            metrics["moe_aux"] = aux.detach()
        return metrics

    def take_grads(params, scale):
        """The parameters' gradients (zeros where none), unscaled, and
        ``.grad`` cleared."""
        grads = {}
        for k, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = g if scale is None else g / scale
            p.grad = None
        return grads

    def grads_and_metrics(
            state: TrainState, batch: dict,
            generator: Union[torch.Generator, Sequence[torch.Generator]]):
        device = next(state.model.parameters()).device
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        params = state.params
        for p in params.values():
            p.grad = None
        scale = state.precision["loss_scale"]["scale"] if scaling else None
        if use_fp8:
            zero_observations(state.model)
        if accum_steps == 1:
            metrics = backward(state, batch, generator, scale)
            return take_grads(params, scale), metrics
        if isinstance(generator, torch.Generator) or \
                len(generator) != accum_steps:
            raise ValueError(f"accum_steps={accum_steps} takes one "
                             f"generator per microbatch")
        micro = microbatch(batch, accum_steps)
        metrics, grads = {}, None
        for a, gen in enumerate(generator):
            m = backward(state, {k: v[a] for k, v in micro.items()}, gen,
                         scale)
            metrics = {k: metrics[k] + v if metrics else v
                       for k, v in m.items()}
            if scale is not None:
                # Unscaled per microbatch (tpudl's order), then summed.
                part = take_grads(params, scale)
                grads = part if grads is None else {
                    k: grads[k].add_(g) for k, g in part.items()}
        metrics = {k: v / accum_steps for k, v in metrics.items()}
        if grads is None:
            grads = take_grads(params, None)
        for g in grads.values():
            g.div_(accum_steps)
        return grads, metrics

    def seeds(state: TrainState, rng: int) -> List[int]:
        """The seeds of the step's generators: ``fold_in(rng,
        state.step)``'s, or microbatch a's ``fold_in(fold_seed(rng,
        state.step), a)``."""
        seed = fold_seed(rng, state.step)
        if accum_steps == 1:
            return [seed]
        return [fold_seed(seed, a) for a in range(accum_steps)]

    def policy_update(state: TrainState, grads, metrics, stats) -> None:
        """The update under a policy: the optimizer gated by ``ok``, the
        statistics put back on a skip, the loss-scale transition and the
        rings (all on the device); then the host counts, which advance
        unless the step was skipped (``ok`` read back, outside a
        capture)."""
        tx, opt_state = state.tx, state.opt_state
        tx.prepare_(opt_state)
        ok = None
        if scaling:
            ok = precision_mod.all_finite(grads.values())
            ls = state.precision["loss_scale"]
            metrics["loss_scale"] = ls["scale"].clone()
            metrics["grad_skipped"] = (~ok).float()
        tx.update_(state.params, grads, opt_state, ok=ok)
        if scaling:
            with torch.no_grad():
                for k, v in (stats or {}).items():
                    live = state.batch_stats[k]
                    live.copy_(torch.where(ok, live, v))
            precision_mod.update_loss_scale_(ls, policy.loss_scale, ok)
        if use_fp8:
            advance_rings(state.model, ok)
        capturing = torch.cuda.is_available() and \
            torch.cuda.is_current_stream_capturing()
        if ok is not None and not capturing and not bool(ok):
            return
        tx.advance_(opt_state)
        state.step += 1

    def step(state: TrainState, batch: dict, rng: int,
             generators: Optional[Sequence[torch.Generator]] = None):
        if generators is None:
            device = next(state.model.parameters()).device
            generators = [torch.Generator(device=device).manual_seed(s)
                          for s in seeds(state, rng)]
        generator = generators[0] if accum_steps == 1 else generators
        if policy is None:
            grads, metrics = grads_and_metrics(state, batch, generator)
            state.apply_gradients(grads)
            return state, metrics
        stats = None
        if scaling and state.batch_stats is not None:
            # A skipped step puts the statistics its forward moved back.
            stats = {k: v.clone() for k, v in state.batch_stats.items()}
        grads, metrics = grads_and_metrics(state, batch, generator)
        policy_update(state, grads, metrics, stats)
        return state, metrics

    step.grads_and_metrics = grads_and_metrics
    step.seeds = seeds
    step.precision = policy
    return step


def make_classification_eval_step(
    input_keys: "str | tuple" = ("image",),
    label_key: str = "label",
    input_transform: Optional[Callable[[dict], dict]] = None,
    loss_impl: str = "reference",
) -> Callable:
    """Eval step: ``step(state, batch) -> {"loss", "accuracy"}``, the mean
    per-example loss and accuracy over the batch as 0-d tensors on the
    device, from a forward with ``train=False`` under ``torch.no_grad``
    (so the fused loss runs its forward kernel only).

    ``loss_impl``: see the module docstring. A ``"_valid"`` batch column
    ([B] 0/1 row mask) switches both reductions to masked means over the
    real rows only, so a zero-padded tail batch reports exactly the
    metrics of its real rows; without it they are plain means. An
    fp8-trained model's sites quantize with their rings' scales (the
    numerics the train forward saw) and, without autograd, record
    nothing: the rings do not move (tpudl's eval step reads
    ``state.precision["fp8"]`` the same way)."""
    if isinstance(input_keys, str):
        input_keys = (input_keys,)

    def step(state: TrainState, batch: dict):
        device = next(state.model.parameters()).device
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if input_transform is not None:
            batch = input_transform(batch)
        with torch.no_grad():
            logits = state.model(*(batch[k] for k in input_keys), train=False)
            labels = batch[label_key].long()
            per_loss = softmax_cross_entropy(logits, labels, impl=loss_impl)
            correct = (logits.argmax(-1) == labels).float()
            valid = batch.get("_valid")
            if valid is None:
                return {"loss": per_loss.mean(), "accuracy": correct.mean()}
            w = valid.float()
            denom = w.sum().clamp_min(1.0)
            return {"loss": (per_loss * w).sum() / denom,
                    "accuracy": (correct * w).sum() / denom}

    # evaluate() pads a ragged tail only into a step that weights the
    # pads out (tpudl's ``_tpudl_mask_aware``).
    step.mask_aware = True
    return step


def _uses_remat(model: nn.Module) -> bool:
    return any(getattr(getattr(m, "cfg", None), "remat", False)
               for m in model.modules())


class CompiledStep:
    """The callable ``compile_step`` returns: ``step(state, batch, rng)``
    for a train step, ``step(state, batch)`` for an eval step (see
    ``compile_step``). ``captured`` says whether the graph exists,
    ``capture_s`` what its capture took."""

    def __init__(self, step_fn, state, has_rng, preprocess):
        self.step_fn = step_fn
        self.state = state
        self.has_rng = has_rng
        self.preprocess = preprocess
        self.device_type = next(state.model.parameters()).device.type
        self.calls = 0
        self.graph: Optional[Graph] = None
        self.inputs: Optional[StaticInputs] = None
        self.generators: List[torch.Generator] = []
        # A remat model's segments, recorded by the eager warm-up call,
        # and the recompute twins the capture registers (models/remat.py).
        self.remat = has_rng and _uses_remat(state.model)
        self.segments: List[tuple] = []
        self.twins = None
        self.outputs = None
        if getattr(step_fn, "mask_aware", False):
            self.mask_aware = True

    @property
    def captured(self) -> bool:
        return self.graph is not None

    @property
    def capture_s(self) -> Optional[float]:
        return None if self.graph is None else self.graph.capture_s

    @property
    def compile_pending(self) -> bool:
        """Whether the next call is a compile (tpudl's first-call marker,
        read before each call by fit and evaluate to record it as
        ``compile``): on the card the eager warm-up and the capture, on
        the CPU the first call."""
        if self.device_type == "cuda":
            return self.graph is None
        return self.calls == 0

    def _run(self, state, batch, rng=None, generators=None):
        if self.preprocess is not None:
            device = next(state.model.parameters()).device
            batch = self.preprocess(
                {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        if not self.has_rng:
            return self.step_fn(state, batch)
        if generators is None:
            return self.step_fn(state, batch, rng)
        return self.step_fn(state, batch, rng, generators=generators)

    def __call__(self, state: TrainState, batch: dict, rng=None):
        if state is not self.state:
            raise ValueError("a compiled step runs on the state it was "
                             "compiled for (its graph holds that state's "
                             "tensors)")
        device = next(state.model.parameters()).device
        self.calls += 1
        if device.type != "cuda":
            return self._run(state, batch, rng)
        if self.calls == 1:
            if not self.remat:
                return self._run(state, batch, rng)
            with remat.recording() as segments:
                out = self._run(state, batch, rng)
            order: List[torch.Generator] = []
            for gen, _ in segments:
                if not any(gen is g for g in order):
                    order.append(gen)
            self.segments = [(next(j for j, g in enumerate(order)
                                   if g is gen), offset)
                             for gen, offset in segments]
            return out
        if self.graph is None:
            self._capture(state, batch, rng, device)
        else:
            self.inputs.fill(batch)
        if self.has_rng:
            seeds = self.step_fn.seeds(state, rng)
            for gen, seed in zip(self.generators, seeds):
                gen.manual_seed(seed)
            if self.twins is not None:
                self.twins.prepare(seeds)
            state.tx.prepare_(state.opt_state)
        self.graph.replay()
        # The graph rewrites its outputs on the next replay.
        if not self.has_rng:
            return {k: v.clone() for k, v in self.outputs.items()}
        metrics = {k: v.clone() for k, v in self.outputs[1].items()}
        # A loss-scaling step that skipped its update leaves the host's
        # counts too (one byte read back, the eager step's rule).
        skipped = metrics.get("grad_skipped")
        if skipped is None or not bool(skipped):
            state.step += 1
            state.tx.advance_(state.opt_state)
        return state, metrics

    def _capture(self, state, batch, rng, device) -> None:
        self.inputs = StaticInputs(batch, device)
        if self.has_rng:
            self.generators = [torch.Generator(device=device)
                               for _ in self.step_fn.seeds(state, rng)]
        if state.graph_pool is None:
            state.graph_pool = torch.cuda.graph_pool_handle()
        twins = []
        context = contextlib.nullcontext()
        if self.segments:
            self.twins = remat.CaptureTwins(self.segments, self.generators)
            twins = self.twins.twins
            context = remat.capturing(self.twins)
        self.graph = Graph(self.generators + twins, pool=state.graph_pool)
        # The capture runs the step's Python, which moves the host counts
        # without running the update: put them back.
        step, host_count = state.step, state.opt_state.get("host_count")
        try:
            with context:
                self.outputs = self.graph.capture(
                    self._run, state, self.inputs.bufs, rng,
                    self.generators if self.has_rng else None)
        finally:
            state.step = step
            if host_count is not None:
                state.opt_state["host_count"] = host_count


def compile_step(
    step_fn: Callable,
    state: TrainState,
    has_rng: bool = True,
    donate_state: Optional[bool] = None,
    preprocess: Optional[Callable[[dict], dict]] = None,
    steps_per_dispatch: int = 1,
    precision=None,
    *,
    mesh=None,
    rules=None,
) -> CompiledStep:
    """tpudl's ``compile_step`` on one card: ``step_fn`` captured as a CUDA
    graph (tpudl_torch.graphs) for ``state``.

    A train step (``has_rng=True``, built by
    ``make_classification_train_step``) becomes ``step(state, batch, rng)
    -> (state, metrics)``, an eval step (``has_rng=False``) ``step(state,
    batch) -> metrics``. On a CUDA state the first call runs eagerly (the
    warm-up: the kernels build, cuDNN settles its algorithms, the
    allocator fills); the second captures the whole step, microbatches and
    update included, and replays it once; every later call copies the
    batch into the graph's input buffers, reseeds the step's generators
    from ``step_fn.seeds(state, rng)``, fills the optimizer's device
    scalars and replays. No call applies an update the eager loop would
    not, and each draws the eager step's bits. The metrics returned are
    copies. A batch of other keys, shapes or dtypes than the captured one
    raises a ``ValueError`` naming both; a failed capture raises; nothing
    falls back to eager. On a CPU state every call runs the step eagerly.
    The state's train and eval graphs share one memory pool
    (``state.graph_pool``). ``preprocess`` runs on the batch inside the
    graph, before ``step_fn``.

    ``precision``: the policy (or preset name) the step was built with.
    compile_step checks that the state carries the policy's state (the
    loss scale, the fp8 rings) and raises a ``ValueError`` naming what is
    missing otherwise; the step object exposes it as ``.precision``. The
    loss scale and the rings are device tensors the graph reads and moves
    in place; after each replay of a loss-scaling step the host reads
    ``grad_skipped`` back and advances ``state.step`` and the
    optimizer's host count only when the step was not skipped.

    Raise NotImplementedError: ``mesh`` / ``rules`` (queue A item 7) and
    ``steps_per_dispatch`` > 1 (item 10: the captured K-step graph). A
    model with remat is captured too: its
    recomputes draw from twin generators registered with the capture
    (tpudl_torch.models.remat), which the warm-up call's recorded segment
    offsets position before each replay. tpudl's
    donation has no counterpart: a train step updates the state in place,
    an eval step leaves it alone, so ``donate_state`` may only say so."""
    if mesh is not None or rules is not None:
        _refuse("mesh", mesh if mesh is not None else rules,
                "queue A item 7 (launcher and sharding)")
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    if steps_per_dispatch > 1:
        _refuse("steps_per_dispatch", steps_per_dispatch,
                "queue A item 10 (the captured K-step graph)")
    policy = precision_mod.resolve_policy(precision)
    precision_mod.validate_state(policy, state)
    if donate_state is not None and bool(donate_state) != has_rng:
        raise ValueError(
            f"donate_state={donate_state!r}: a train step updates its state "
            f"in place and an eval step leaves it alone (has_rng={has_rng})")
    if has_rng and not hasattr(step_fn, "seeds"):
        raise TypeError("compile_step captures train steps built by "
                        "make_classification_train_step (it reseeds their "
                        "generators, step_fn.seeds, before each replay)")
    compiled = CompiledStep(step_fn, state, has_rng, preprocess)
    compiled.precision = policy
    return compiled


def pad_batch(batch: dict, to_size: int) -> dict:
    """Pad every [B, ...] column of ``batch`` (arrays or tensors) to
    ``to_size`` rows with zeros and add a ``"_valid"`` float32
    [to_size] column: 1.0 on the real rows, 0.0 on the pads. An existing
    ``"_valid"`` column is extended with zeros."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    b = next(iter(sizes.values()))
    if any(s != b for s in sizes.values()):
        raise ValueError(f"ragged leading dims within one batch: {sizes}")
    if to_size < b:
        raise ValueError(f"cannot pad batch of {b} down to {to_size}")

    def pad0(x, width):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((width, *x.shape[1:]))])
        x = np.asarray(x)
        return np.pad(x, [(0, width)] + [(0, 0)] * (x.ndim - 1))

    valid = batch.get("_valid")
    if valid is None:
        valid = np.ones((b,), np.float32)
    out = {k: pad0(v, to_size - b) for k, v in batch.items() if k != "_valid"}
    out["_valid"] = pad0(valid, to_size - b)
    return out


def _obs_pull(rec, it, attrs):
    """Timed ``next(it)`` recording a data_wait span (tpudl's): the
    instrumented arm shared by fit and evaluate, whose uninstrumented
    paths stay inline. Returns ``(batch, wait_seconds)`` or None on
    exhaustion."""
    t0 = rec.clock()
    try:
        batch = next(it)
    except StopIteration:
        return None
    dur = rec.clock() - t0
    rec.record("data_wait", obs_spans.CAT_DATA_WAIT, t0, dur, attrs)
    return batch, dur


def evaluate(
    eval_step: Callable,
    state: TrainState,
    batches: Iterable[dict],
    num_steps: Optional[int] = None,
    pad_to: Optional[int] = None,
) -> dict:
    """Drive ``eval_step`` over ``batches`` (at most ``num_steps``) and
    return the example-weighted mean of each metric as a float: each
    batch weighs its real rows (the sum of a ``"_valid"`` column, else
    its size). The first batch's size (or ``pad_to``) is the target: a
    smaller later batch is zero-padded to it with a ``"_valid"`` mask
    (``pad_batch``) when the step carries the ``mask_aware`` marker
    (``make_classification_eval_step`` does) or ``pad_to`` is given;
    otherwise it runs at its own size. A compiled step
    (``compile_step``) replays one graph of one batch signature, so there
    every batch of a mask-aware step carries the ``"_valid"`` column
    (all ones on a full batch). The metrics stay on the device until the
    one read at the end.

    With a span recorder active (tpudl_torch.obs), each batch pull
    records a ``data_wait`` span and each call an ``eval_step`` span,
    in ``compile`` while a compiled step's ``compile_pending`` holds and
    in ``eval`` after (tpudl's)."""
    if num_steps is not None and num_steps <= 0:
        raise ValueError(f"num_steps must be positive, got {num_steps}")
    may_pad = pad_to is not None or getattr(eval_step, "mask_aware", False)
    pad_all = may_pad and isinstance(eval_step, CompiledStep)
    rec = obs_spans.active_recorder()
    totals: dict = {}
    n_examples = 0.0
    target = pad_to
    it = iter(batches)
    i = 0
    while num_steps is None or i < num_steps:
        if rec is None:
            try:
                batch = next(it)
            except StopIteration:
                break
        else:
            pulled = _obs_pull(rec, it, {"step": i, "phase": "eval"})
            if pulled is None:
                break
            batch = pulled[0]
        bs = next(iter(batch.values())).shape[0]
        if "_valid" in batch:
            weight = float(torch.as_tensor(batch["_valid"]).sum())
        else:
            weight = float(bs)
        if target is None:
            target = bs
        if (bs < target or pad_all) and may_pad:
            batch = pad_batch(batch, max(bs, target))
        if rec is None:
            metrics = eval_step(state, batch)
        else:
            is_compile = getattr(eval_step, "compile_pending", False)
            t0 = rec.clock()
            metrics = eval_step(state, batch)
            t1 = rec.clock()
            # CAT_EVAL, not CAT_STEP: eval steps have their own duration
            # scale.
            rec.record(
                "eval_step",
                obs_spans.CAT_COMPILE if is_compile else obs_spans.CAT_EVAL,
                t0, t1 - t0, {"step": i, "phase": "eval"})
        n_examples += weight
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + v * weight
        i += 1
    if n_examples == 0:
        raise ValueError("evaluate() received no batches")
    return {k: float(v) / n_examples for k, v in totals.items()}


def _to_host(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _start_profile(state: TrainState):
    """A started torch.profiler session: CPU activity, plus CUDA on the
    card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if next(state.model.parameters()).device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, profile_dir: str, state: TrainState) -> str:
    """Wait for the card (tpudl's block_until_ready before stop_trace),
    stop the session and write its Chrome trace under ``profile_dir``."""
    import socket

    if next(state.model.parameters()).device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = trace_path(profile_dir, socket.gethostname(), os.getpid(),
                      int(time.time() * 1e3))
    prof.export_chrome_trace(path)
    return path


def fit(
    step_fn: Callable,
    state: TrainState,
    batches: Iterable[dict],
    rng: int,
    num_steps: Optional[int] = None,
    log_every: int = 0,
    logger: Optional[Callable[[int, dict], None]] = None,
    profile_dir: Optional[str] = None,
    profile_window: tuple = (2, 8),
    checkpoint_manager=None,
    checkpoint_every: int = 0,
    steps_per_dispatch: Optional[int] = None,
    async_metrics: Optional[bool] = None,
):
    """Drive ``step_fn`` (a step, or ``compile_step``'s) over ``batches``
    (one step per batch, at most ``num_steps``); returns ``(state, last
    metrics as floats, info)`` with ``info`` = ``{"steps", "seconds",
    "preempted", "profile_trace"}``.
    Every ``log_every`` steps the step's metrics are read back (a wait
    for the card) and handed to ``logger(step, metrics)`` (e.g. a
    tpudl_torch.train.logging.MetricLogger), or printed, and a precision
    policy's state is published to the obs registry
    (``publish_numerics_telemetry``: the loss scale, the skipped steps,
    the fp8 rings' drift); otherwise nothing is read back until the end,
    so the host runs ahead of the card (but for the one-byte ``ok`` of
    a loss-scaling step).

    Checkpointing (tpudl's): with a ``checkpoint_manager``
    (tpudl_torch.checkpoint.CheckpointManager or
    tpudl_torch.ft.AsyncCheckpointManager) the state is saved whenever
    its step count is a multiple of ``checkpoint_every`` (> 0), and once
    at the end. Saves are keyed by the state's own step count
    (``state.step`` when fit starts, plus the steps taken), so a
    restored-and-continued run lines up with an uninterrupted one. A
    manager whose ``save`` takes ``rng`` and ``data_state`` gets full
    resume state: the seed and ``batches.state()`` when ``batches`` has
    one (a tpudl_torch.ft.ResumableIterator). Before each batch fit
    checks the preemption flag (tpudl_torch.ft.preemption): once a
    signal has arrived it pulls no more batches, and the end-of-fit save
    is the emergency checkpoint; ``info["preempted"]`` says so. fit
    waits for the manager's writes before it returns. Restore before
    calling fit (``resume_latest``, or ``tpudl_torch.ft.resume_run`` for
    the full resume state).

    Observability (tpudl's): with a span recorder active
    (TPUDL_OBS_DIR or tpudl_torch.obs.enable), each batch pull records a
    ``data_wait`` span and each step call a ``train_step`` span
    (``step``), or ``compile_step`` (``compile``) while a compiled
    step's ``compile_pending`` holds (on the card its eager warm-up and
    its capture); the ``step_time_s``, ``data_wait_s`` and
    ``compile_time_s`` histograms accumulate in the counters registry,
    snapshotted into the span stream at the end.
    The spans time what the host waits on: a replayed graph returns once
    it is queued, so a step span converges to the device's step time
    only once the host waits on the card (a full queue, a readback).
    tpudl_torch.obs.goodput classifies the records. With no recorder,
    fit reads nothing more back and records nothing. With TPUDL_OBS_PORT
    set fit starts the live exporter (tpudl_torch.obs.exporter); either
    way the ``train_loop`` heartbeat beats once per step call and the
    ``train_last_step`` gauge follows it.

    Profiling (tpudl's): with ``profile_dir`` (or TPUDL_PROFILE_DIR)
    set, steps [profile_window[0], profile_window[1]) are recorded with
    torch.profiler (CUDA activity on the card), skipping a compile call,
    each under a ``tpudl_step#<i>`` annotation; fit waits for the card,
    stops the profiler and writes a Chrome trace into the directory
    (``info["profile_trace"]``), which
    tpudl_torch.train.profiling.summarize_trace reads. One trace a fit.

    tpudl's fused K-step dispatch and asynchronous metrics raise."""
    for name, value, off, item in (
        ("steps_per_dispatch", steps_per_dispatch, (None, 1),
         "queue A item 10 (the captured K-step graph on compile_step)"),
        ("async_metrics", async_metrics, (None, False),
         "queue A item 10 (asynchronous metrics)"),
    ):
        if not any(value is v or value == v for v in off):
            _refuse(name, value, item)
    profile_dir = profile_dir or env_str("TPUDL_PROFILE_DIR")
    prof_start, prof_stop = profile_window
    profiler = None
    prof_done = False  # one trace per fit: no restart after the window
    trace = None
    rec = obs_spans.active_recorder()
    if rec is not None:
        reg = obs_counters.registry()
        h_step = reg.histogram("step_time_s")
        h_data = reg.histogram("data_wait_s")
        h_compile = reg.histogram("compile_time_s")
        clock = rec.clock
    start_step = int(state.step) if checkpoint_manager is not None else 0
    # Full resume is a capability of the manager's save signature.
    full_resume = False
    if checkpoint_manager is not None:
        try:
            params = inspect.signature(checkpoint_manager.save).parameters
            full_resume = "rng" in params and "data_state" in params
        except (TypeError, ValueError):
            pass
    data_position = getattr(batches, "state", None)
    # Live telemetry (tpudl_torch.obs.exporter): with TPUDL_OBS_PORT set
    # the process serves /metrics, /healthz and /snapshot while fit runs;
    # the train_loop heartbeat beats once per dispatch, so a hung loop
    # reads as a growing heartbeat age on /healthz.
    obs_exporter.maybe_start_from_env()
    heartbeat = obs_exporter.Heartbeat("train_loop")
    g_last_step = obs_counters.registry().gauge("train_last_step")

    def save(step_no):
        if full_resume:
            checkpoint_manager.save(
                step_no, state, rng=rng,
                data_state=data_position() if callable(data_position)
                else None)
        else:
            checkpoint_manager.save(step_no, state)

    last_ckpt_step = None
    preempted = False
    metrics = None
    start = time.perf_counter()
    n = 0
    it = iter(batches)
    try:
        while num_steps is None or n < num_steps:
            if ft_preemption.requested():
                # The grace window is ticking: pull no more work; the
                # emergency checkpoint is the end-of-fit save below.
                preempted = True
                if rec is not None:
                    rec.event("preempted", obs_spans.CAT_RECOVERY, step=n)
                obs_counters.registry().counter("ft_preemptions").inc()
                break
            if rec is None:
                try:
                    batch = next(it)
                except StopIteration:
                    break
            else:
                pulled = _obs_pull(rec, it, {"step": n})
                if pulled is None:
                    break
                batch, wait = pulled
                h_data.observe(wait)
            if (profile_dir and profiler is None and not prof_done
                    and prof_start <= n < prof_stop
                    and not getattr(step_fn, "compile_pending", False)):
                profiler = _start_profile(state)
            annotation = (contextlib.nullcontext() if profiler is None else
                          torch.profiler.record_function(
                              f"{STEP_ANNOTATION}{n}"))
            with annotation:
                if rec is None:
                    state, metrics = step_fn(state, batch, rng)
                else:
                    is_compile = getattr(step_fn, "compile_pending", False)
                    t0 = clock()
                    state, metrics = step_fn(state, batch, rng)
                    t1 = clock()
                    if is_compile:
                        rec.record("compile_step", obs_spans.CAT_COMPILE,
                                   t0, t1 - t0, {"step": n})
                        h_compile.observe(t1 - t0)
                    else:
                        rec.record("train_step", obs_spans.CAT_STEP,
                                   t0, t1 - t0, {"step": n})
                        h_step.observe(t1 - t0)
            heartbeat.beat(step=n + 1)
            g_last_step.set(start_step + n + 1)
            if profiler is not None and n + 1 >= prof_stop:
                trace = _stop_profile(profiler, profile_dir, state)
                profiler = None
                prof_done = True
            n += 1
            if checkpoint_manager is not None and checkpoint_every:
                step_no = start_step + n
                if step_no % checkpoint_every == 0:
                    # Safe although the next step updates the state in
                    # place: save() copies it to the host before it
                    # returns.
                    save(step_no)
                    last_ckpt_step = step_no
            if log_every and n % log_every == 0:
                host = _to_host(metrics)
                if logger:
                    logger(n, host)
                else:
                    print(f"step {n}: {host}")
                # The precision state's numerics, at the log cadence only.
                precision_mod.publish_numerics_telemetry(
                    getattr(state, "precision", None))
    finally:
        # An orderly exit (or unwind) is "finished", not "hung": a stopped
        # heartbeat is never stale on /healthz.
        heartbeat.stop()
        if profiler is not None:
            # The window outlived the batches: keep what it recorded.
            trace = _stop_profile(profiler, profile_dir, state)
        if rec is not None:
            rec.counters(obs_counters.registry().snapshot())
    if checkpoint_manager is not None and n:
        step_no = start_step + n
        if last_ckpt_step != step_no:
            # Doubles as the preemption EMERGENCY save: on a grace-window
            # exit this is the last committed state a restart resumes.
            save(step_no)
        checkpoint_manager.wait_until_finished()
        if rec is not None:
            # The final save's counters landed after the loop's snapshot
            # (a report keeps the last snapshot a process).
            rec.counters(obs_counters.registry().snapshot())
    host_metrics = None if metrics is None else _to_host(metrics)
    return state, host_metrics, {"steps": n,
                                 "seconds": time.perf_counter() - start,
                                 "preempted": preempted,
                                 "profile_trace": trace}


def finalize_zero_step_run(checkpoint_manager, state: TrainState,
                           warmup_steps_run: int) -> str:
    """The epilogue of a run where fit() saw zero batches (a resume
    landed at, or within warm-up of, the step budget): fit's final
    checkpoint never fired, so warm-up steps trained outside fit are
    saved here, or every rerun would retrain them. Returns the status
    line to print."""
    if checkpoint_manager is not None and warmup_steps_run:
        checkpoint_manager.save(int(state.step), state)
        checkpoint_manager.wait_until_finished()
    if warmup_steps_run:
        return (f"trained {warmup_steps_run} warmup step(s) only — no "
                f"steady-state throughput window to report")
    return "no training steps this run (budget already met)"


def resume_latest(checkpoint_manager, state: TrainState, mesh=None,
                  rules=None) -> tuple:
    """Restore the latest checkpoint into ``state`` (in place) if one
    exists. Returns ``(state, resumed_step)`` — ``(state, 0)`` untouched
    when the directory is empty, so cold start and resume are one call
    site. Fast-forward the data past the consumed steps, or the resumed
    run re-trains on early batches (``tpudl_torch.ft.resume_run`` does
    this, restoring the seed and the data position too)::

        state, start_step = resume_latest(mgr, state)
        fit(step, state, itertools.islice(batches, start_step, None), rng,
            num_steps=total_steps - start_step, checkpoint_manager=mgr)
    """
    latest = checkpoint_manager.latest_step()
    if latest is None:
        return state, 0
    return (checkpoint_manager.restore(state, latest, mesh=mesh, rules=rules),
            latest)
