"""Mixed-precision training policies: the port's counterpart of
tpudl.train.precision. One declarative contract for compute / param /
reduce dtypes, the optimizer's first-moment storage, fp8 matmul routing
and dynamic loss scaling.

A ``PrecisionPolicy`` answers, per parameter by regex over its tpudl
path (tpudl_torch.rules; each model's ``tpudl_path`` maps a state_dict
name to it), "what dtype does this leaf compute in?" and "what dtype
does its first moment store in?". The masters stay f32 in the model and
every loss and gradient reduction stays f32. The policy is applied
inside the train step (``make_classification_train_step(precision=)``,
``compile_step(precision=)``); its state (the loss scale, the fp8 amax
rings) lives on the card in ``TrainState.precision``, so nothing is read
from the host when a scale moves and a captured step keeps replaying.

Presets (``policy(name)``):

- ``"f32"`` — the identity: the step is bitwise the step without a
  policy.
- ``"bf16"`` — kernels and embedding tables cast to bf16 for the
  forward and backward (f32 masters; the cast's backward returns f32
  gradients); norm scales and biases stay f32; logits and the loss
  reduce in f32. No loss scaling. ``policy("bf16", bf16_moments=True)``
  also stores AdamW's first moment in bf16, which is
  ``OptimConfig(mu_dtype="bfloat16")`` bit for bit.
- ``"fp8"`` — bf16 compute, and the model's ``Fp8Dense`` sites
  (``fp8_train=True``) run the delayed-scaling fp8 product
  (tpudl_torch.ops.fp8_dot), with dynamic loss scaling: the objective is
  multiplied by a power-of-two scale before the backward, the gradients
  are divided by it after, a nonfinite gradient SKIPS the update (the
  parameters, the optimizer state, the step count and the rings stay
  bitwise as they were) and halves the scale, and ``growth_interval``
  clean steps double it.

``configure_model`` threads the compute dtype into a model config's
``dtype`` (as in tpudl, the only way the matmuls move to it);
``cast_params`` casts the rule-matched leaves for the forward (a value
no-op for a projection that casts at use anyway; the embedding tables'
lookup then runs in the compute dtype, as tpudl's does).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from tpudl_torch import rules as rules_engine
from tpudl_torch.rules import Rules

#: Default cast rules: matmul weights and embedding tables compute in
#: the policy dtype; everything else stays f32.
DEFAULT_CAST_RULES: Rules = (
    (r"(kernel|embedding)$", "compute"),
    (r".*", None),
)

#: Rule-selected bf16 first moments (the second moment stays f32).
BF16_MOMENT_RULES: Rules = ((r".*", "bfloat16"),)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_loss_scale_config() -> "LossScaleConfig":
    from tpudl_torch.analysis.registry import env_float, env_int

    return LossScaleConfig(
        init=env_float("TPUDL_LOSS_SCALE_INIT", 2.0**15),
        growth_interval=env_int("TPUDL_LOSS_SCALE_GROWTH_INTERVAL", 2000,
                                min_value=1),
    )


@dataclasses.dataclass(frozen=True)
class LossScaleConfig:
    """Dynamic loss scaling (Micikevicius et al.): multiply the loss by
    ``scale`` before the backward, divide the gradients by it after; a
    nonfinite gradient skips the step and backs off, ``growth_interval``
    finite steps in a row double it (capped)."""

    init: float = 2.0**15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    max_scale: float = 2.0**24
    min_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """The mixed-precision contract (module docstring). Rule fields
    follow tpudl_torch.rules: regex over the leaf's tpudl path, first
    match wins. tpudl's ``param_dtype`` and ``amax_window`` are left
    out, since nothing reads them: the masters are always f32, and each
    Fp8Dense sizes its rings from TPUDL_FP8_AMAX_WINDOW when it is
    built."""

    name: str
    compute_dtype: torch.dtype = torch.float32
    #: Logits and the loss reduce in this dtype.
    reduce_dtype: torch.dtype = torch.float32
    #: regex -> "compute" | None: which leaves cast to compute_dtype.
    cast_rules: Rules = DEFAULT_CAST_RULES
    #: regex -> dtype name | None: first-moment storage per leaf.
    moment_rules: Rules = ()
    #: Run the model's Fp8Dense sites and carry their rings.
    use_fp8: bool = False
    #: Dynamic loss scaling; None = off.
    loss_scale: Optional[LossScaleConfig] = None

    def configure_model(self, cfg: Any) -> Any:
        """``cfg`` with its ``dtype`` set to the compute dtype (raises for
        a config without that seam)."""
        if not hasattr(cfg, "dtype"):
            raise ValueError(
                f"{type(cfg).__name__} has no dtype seam to carry the "
                f"policy's compute dtype — models without one run at "
                f"their promoted dtype regardless of the policy")
        return dataclasses.replace(cfg, dtype=self.compute_dtype)

    def cast_params(self, params: Dict[str, torch.Tensor],
                    path: Callable[[str], str] = rules_engine.path_str
                    ) -> Dict[str, torch.Tensor]:
        """The rule-matched float leaves of ``params`` (name -> tensor)
        cast to ``compute_dtype``, the others as they are. The cast is
        differentiable: the forward runs on the casts, the gradients
        land on the f32 masters in f32."""
        ann = rules_engine.annotate(self.cast_rules, params, path=path,
                                    what="precision cast rule")
        return {k: p.to(self.compute_dtype)
                if ann[k] == "compute" and p.is_floating_point() else p
                for k, p in params.items()}

    def moment_dtypes(self, params: Dict[str, torch.Tensor],
                      path: Callable[[str], str] = rules_engine.path_str
                      ) -> Dict[str, torch.dtype]:
        """name -> first-moment dtype for the leaves a moment rule
        selects (uncovered leaves keep the optimizer's own dtype)."""
        if not self.moment_rules:
            return {}
        ann = rules_engine.annotate(self.moment_rules, params, path=path,
                                    default=None, what="moment rule")
        return {k: _DTYPES[d] for k, d in ann.items() if d}


def policy(name: str, bf16_moments: bool = False) -> PrecisionPolicy:
    """Preset factory (module docstring); ``bf16_moments`` adds the
    rule-selected bf16 first moment to any preset."""
    moment_rules = BF16_MOMENT_RULES if bf16_moments else ()
    if name == "f32":
        return PrecisionPolicy(name="f32", cast_rules=((r".*", None),),
                               moment_rules=moment_rules)
    if name == "bf16":
        return PrecisionPolicy(name="bf16", compute_dtype=torch.bfloat16,
                               moment_rules=moment_rules)
    if name == "fp8":
        return PrecisionPolicy(
            name="fp8", compute_dtype=torch.bfloat16,
            moment_rules=moment_rules, use_fp8=True,
            loss_scale=default_loss_scale_config())
    raise ValueError(
        f"unknown precision policy {name!r}; expected f32 | bf16 | fp8")


def resolve_policy(precision) -> Optional[PrecisionPolicy]:
    """None / preset name / policy -> policy (None passes through)."""
    if precision is None or isinstance(precision, PrecisionPolicy):
        return precision
    return policy(precision)


def policy_from_env() -> Optional[PrecisionPolicy]:
    """TPUDL_TRAIN_PRECISION -> policy (unset = None)."""
    from tpudl_torch.analysis.registry import env_str

    name = env_str("TPUDL_TRAIN_PRECISION")
    return None if not name else resolve_policy(name)


# ---------------------------------------------------------------------------
# Precision state: TrainState.precision, on the card.
# ---------------------------------------------------------------------------


def init_precision_state(pol: Optional[PrecisionPolicy], fp8_vars: Any = None,
                         device="cpu") -> Optional[dict]:
    """The ``TrainState.precision`` tree of a policy, in tpudl's layout:
    ``{"loss_scale": {"scale" f32, "growth_count" int32, "skipped"
    int32}}`` when scaling is on, ``"fp8"`` = ``fp8_vars`` (the model's
    rings, tpudl_torch.ops.fp8_dot.fp8_state) when fp8 is on; None when
    the policy carries no state."""
    if pol is None:
        return None
    state: dict = {}
    if pol.loss_scale is not None:
        state["loss_scale"] = {
            "scale": torch.tensor(pol.loss_scale.init, dtype=torch.float32,
                                  device=device),
            "growth_count": torch.zeros((), dtype=torch.int32, device=device),
            "skipped": torch.zeros((), dtype=torch.int32, device=device),
        }
    if pol.use_fp8:
        if fp8_vars is None:
            raise ValueError(
                "precision policy 'fp8' needs a model with fp8 matmul "
                "sites — build it with cfg.fp8_train=True so the "
                "projection Denses are Fp8Dense (they hold the amax rings)")
        state["fp8"] = fp8_vars
    return state or None


def validate_state(pol: Optional[PrecisionPolicy], state: Any) -> None:
    """compile_step's gate: a policy that carries state must find it on
    the TrainState."""
    if pol is None:
        return
    prec = getattr(state, "precision", None)
    if pol.loss_scale is not None and (prec is None
                                       or "loss_scale" not in prec):
        raise ValueError(
            f"policy {pol.name!r} uses dynamic loss scaling but the "
            f"TrainState carries no loss-scale state — build it with "
            f"create_train_state(..., precision=policy)")
    if pol.use_fp8 and (prec is None or "fp8" not in prec):
        raise ValueError(
            f"policy {pol.name!r} routes matmuls through fp8 but the "
            f"TrainState carries no amax state — build the model with "
            f"cfg.fp8_train=True and the state with "
            f"create_train_state(..., precision=policy)")


def all_finite(tensors) -> torch.Tensor:
    """Device bool: every float tensor of ``tensors`` is finite (the
    skip-step predicate; no host read)."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


@torch.no_grad()
def update_loss_scale_(ls: Dict[str, torch.Tensor], cfg: LossScaleConfig,
                       ok: torch.Tensor) -> None:
    """One dynamic-loss-scale transition, in place: a finite step counts
    toward growth (doubling after ``growth_interval`` in a row, capped);
    a nonfinite one backs off (floored) and resets the streak."""
    scale, count = ls["scale"], ls["growth_count"]
    grown = ok & (count + 1 >= cfg.growth_interval)
    new_scale = torch.where(
        ok,
        torch.where(grown, (scale * cfg.growth_factor).clamp_max(
            cfg.max_scale), scale),
        (scale * cfg.backoff_factor).clamp_min(cfg.min_scale))
    new_count = torch.where(ok & ~grown, count + 1,
                            torch.zeros_like(count))
    ls["skipped"].add_((~ok).to(torch.int32))
    scale.copy_(new_scale)
    count.copy_(new_count)


def update_loss_scale(ls: Dict[str, torch.Tensor], cfg: LossScaleConfig,
                      ok) -> Dict[str, torch.Tensor]:
    """tpudl's functional ``update_loss_scale``: the next loss-scale
    state as new tensors (``ls`` untouched)."""
    new = {k: v.clone() for k, v in ls.items()}
    update_loss_scale_(new, cfg, torch.as_tensor(ok, device=new["scale"].device))
    return new


def publish_numerics_telemetry(precision_state: Any) -> None:
    """Push the precision state into the obs registry (fit calls it at
    its log cadence; device reads per publish, never per step):
    ``train_loss_scale`` gauge, ``train_grad_skipped_total`` counter
    (advanced by the delta of the cumulative ``skipped``) and
    ``train_fp8_amax_drift`` histogram (per ring, ``(max - min) / max``
    over the window). A None or empty state does nothing."""
    if not precision_state:
        return
    from tpudl_torch.obs import counters as obs_counters

    reg = obs_counters.registry()
    ls = precision_state.get("loss_scale")
    if ls is not None:
        reg.gauge("train_loss_scale").set(float(ls["scale"]))
        skipped = int(ls["skipped"])
        ctr = reg.counter("train_grad_skipped_total")
        delta = skipped - int(ctr.value)
        if delta > 0:
            ctr.inc(delta)
    fp8 = precision_state.get("fp8")
    if fp8 is not None:
        hist = reg.histogram("train_fp8_amax_drift")

        def walk(node):
            for key, val in node.items():
                if isinstance(val, dict):
                    walk(val)
                elif str(key).endswith("_hist") and val.numel():
                    ring = val.detach().float().cpu()
                    hi = float(ring.max())
                    if hi > 0.0:
                        hist.observe((hi - float(ring.min())) / hi)

        walk(fp8)
