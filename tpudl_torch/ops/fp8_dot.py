"""fp8 matmul with delayed scaling for training: e4m3 forward, e5m2
gradient. The port's counterpart of tpudl.ops.fp8_dot.

Each projection site keeps three rings of the last ``window`` step
amaxes (x, w and the incoming gradient g); a tensor's quantization
scale is its ring's max over the format's finite max, and the step's
own amaxes are recorded for the NEXT step's scales. The scales are
device scalars computed from device rings, so a step reads nothing
from the host and a CUDA graph can capture it.

- ``_cast_fp8`` divides in f32 by the scale, clips to the format's
  finite max (a bare cast to e4m3 maps overflow to NaN), then casts:
  ``torch.float8_e4m3fn`` for x and w, ``torch.float8_e5m2`` for g, the
  formats of ``jnp.float8_*``, both rounding to nearest even (the casts
  agree bit for bit with tpudl's, tests/test_torch_precision.py).
- ``fp8_dot`` is a ``torch.autograd.Function``. The forward computes
  ``out = (qx @ qw^T) * (sx * sw)`` with f32 accumulation and keeps qx
  and qw in fp8 for the backward. The backward takes g's amax, quantizes
  g to e5m2 with the scale of ``g_hist``, and computes ``dx = (qg @ qw)
  * (sg * sw)`` and ``dw = (qg^T @ qx) * (sg * sx)`` (the weight is
  ``[out, in]``, tpudl's kernel transposed); it skips dw when the weight
  needs no gradient, so a frozen LoRA base pays for no weight-gradient
  product. dx and dw come out in x's and w's dtypes, as tpudl's custom
  VJP casts them.
- ``Fp8Dense`` is ``nn.Dense``-identical (an f32 master ``weight`` ``[out,
  in]`` and ``bias``, cast to the compute dtype at use) plus tpudl's
  rank-r ``lora_a`` / ``lora_b``. The rings are buffers (``x_hist``,
  ``w_hist``, ``g_hist``, and ``g_probe``, tpudl's layout leaf, always
  0). The step's observations ``x_amax``, ``w_amax`` and ``g_amax`` are
  device scalars that combine by max: max covers tpudl's max-combine
  over microbatches, and it is idempotent, so a remat recompute records
  nothing twice. A forward without autograd (eval, serving, export)
  records nothing, as tpudl's read-only apply drops its sow. The train
  step (tpudl_torch.train.loop) zeros the observations before its
  forward and advances the rings from them after its update
  (``advance_rings``). The rings and observations are non-persistent
  buffers: the state_dict is the plain module's, and the rings travel
  as ``TrainState.precision["fp8"]`` (``fp8_state``).

Dispatch by device (the port's rule, tpudl_torch.ops.norms.resolve_impl):
"auto" on a CUDA tensor runs ``torch._scaled_mm`` (the fp8 tensor cores;
tpudl computes this product with XLA's dot, not a Pallas kernel, so the
library product stands where tpudl's stands); "auto" on a CPU tensor
runs the plain version, which dequantizes to f32 and multiplies in f32
(tpudl's ``impl="reference"``, the parity baseline); "fused" on a CPU
tensor raises. ``_scaled_mm`` takes the first operand row-major and the
second column-major, with every dimension a multiple of 16: a shape it
refuses raises, naming the shape; nothing falls back. The forward needs
no copy (``qw^T`` of the row-major ``[out, in]`` weight is
column-major); dx needs a transposed copy of qw, and dw transposed
copies of qg and qx. ``fp8_dot.launches_fwd`` / ``launches_dx`` /
``launches_dw`` count the ``_scaled_mm`` calls.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tpudl_torch.ops.norms import resolve_impl

#: Largest finite magnitudes of the two training formats.
E4M3_MAX = 448.0
E5M2_MAX = 57344.0

#: Default amax-history ring length (TPUDL_FP8_AMAX_WINDOW overrides).
DEFAULT_AMAX_WINDOW = 16

#: ``_scaled_mm``'s granule: every dimension a multiple of it.
_MM_ALIGN = 16


def fp8_train_impl(flag) -> str:
    """A model config's ``fp8_train`` -> the product's ``impl`` (tpudl's
    mapping: a string names it, "force" is "fused"; True is "auto")."""
    impl = flag if isinstance(flag, str) else "auto"
    return "fused" if impl == "force" else impl


def default_amax_window() -> int:
    from tpudl_torch.analysis.registry import env_int

    return env_int("TPUDL_FP8_AMAX_WINDOW", DEFAULT_AMAX_WINDOW, min_value=1)


def amax_history_init(window: int, device=None) -> torch.Tensor:
    """A fresh ring: all zeros, so the scale is 1.0 until the first real
    amax lands (see ``history_scale``)."""
    return torch.zeros(int(window), dtype=torch.float32, device=device)


def update_amax_history(hist: torch.Tensor, amax: torch.Tensor
                        ) -> torch.Tensor:
    """Ring insert: the newest amax at slot 0, the oldest falls off. A
    nonfinite amax is replaced by the window's current max, so one bad
    step cannot poison ``window`` future scales."""
    amax = torch.as_tensor(amax, dtype=torch.float32, device=hist.device)
    amax = torch.where(torch.isfinite(amax), amax, hist.max())
    return torch.cat([amax.reshape(1), hist[:-1]])


def history_scale(hist: torch.Tensor, dtype_max: float) -> torch.Tensor:
    """The quantization scale from a ring: ``max(hist) / dtype_max``; an
    all-zero ring scales by 1.0."""
    amax = hist.max()
    return torch.where(amax > 0.0, amax / dtype_max, torch.ones_like(amax))


def _cast_fp8(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
              dtype_max: float) -> torch.Tensor:
    """Scale, clip to the finite max, cast (tpudl's ``_cast_fp8``)."""
    scaled = x.float() / scale
    return scaled.clamp_(-dtype_max, dtype_max).to(dtype)


def _check_mm_shape(m: int, k: int, n: int, what: str) -> None:
    if m % _MM_ALIGN or k % _MM_ALIGN or n % _MM_ALIGN:
        raise ValueError(
            f"fp8_dot {what}: torch._scaled_mm takes [M, K] @ [K, N] with M, "
            f"K and N multiples of {_MM_ALIGN}; got M={m}, K={k}, N={n}")


def _product(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
             sb: torch.Tensor, out_dtype: torch.dtype, native: bool,
             what: str) -> torch.Tensor:
    """``(a @ b) * (sa * sb)`` in f32, rounded once to ``out_dtype``;
    ``a`` [M, K] and ``b`` [K, N] fp8. ``native``: ``torch._scaled_mm``
    on the card (``a`` row-major, ``b`` column-major; a copy is made
    where the operand is not); otherwise the plain version."""
    if not native:
        return ((a.float() @ b.float()) * (sa * sb)).to(out_dtype)
    _check_mm_shape(a.shape[0], a.shape[1], b.shape[1], what)
    if not a.is_contiguous():
        a = a.contiguous()
    if not b.t().is_contiguous():
        b = b.t().contiguous().t()
    setattr(fp8_dot, f"launches_{what}",
            getattr(fp8_dot, f"launches_{what}") + 1)
    return torch._scaled_mm(a, b, scale_a=sa, scale_b=sb,
                            out_dtype=out_dtype, use_fast_accum=False)


class _Fp8Dot(torch.autograd.Function):
    """The custom-VJP fp8 product (see the module docstring). ``g_amax``
    (optional) is the site's observation scalar, max-combined with the
    backward's gradient amax in place. ``probe`` is tpudl's ``g_probe``:
    a scalar that requires a gradient, so the backward runs (and records
    g's amax) even where neither x nor w needs one, as at a frozen
    base's first layer."""

    @staticmethod
    def forward(ctx, x, w, x_hist, w_hist, g_hist, g_amax, probe, native):
        sx = history_scale(x_hist, E4M3_MAX)
        sw = history_scale(w_hist, E4M3_MAX)
        x2 = x.reshape(-1, x.shape[-1])
        qx = _cast_fp8(x2, sx, torch.float8_e4m3fn, E4M3_MAX)
        qw = _cast_fp8(w, sw, torch.float8_e4m3fn, E4M3_MAX)
        out = _product(qx, qw.t(), sx, sw, x.dtype, native, "fwd")
        ctx.save_for_backward(qx, qw, sx, sw, g_hist)
        # Not a saved tensor: every backward of the step writes it.
        ctx.g_amax = g_amax
        ctx.native = native
        ctx.x_shape = x.shape
        ctx.dtypes = (x.dtype, w.dtype)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw, g_hist = ctx.saved_tensors
        g_amax = ctx.g_amax
        g2 = g.float().reshape(-1, g.shape[-1])
        if g_amax is not None:
            g_amax.copy_(torch.maximum(g_amax, g2.abs().max()))
        dx = dw = None
        if not any(ctx.needs_input_grad[:2]):
            return (None,) * 8
        sg = history_scale(g_hist, E5M2_MAX)
        qg = _cast_fp8(g2, sg, torch.float8_e5m2, E5M2_MAX)
        x_dtype, w_dtype = ctx.dtypes
        if ctx.needs_input_grad[0]:
            dx = _product(qg, qw, sg, sw, x_dtype, ctx.native,
                          "dx").reshape(ctx.x_shape)
        if ctx.needs_input_grad[1]:
            dw = _product(qg.t(), qx, sg, sx, w_dtype, ctx.native, "dw")
        return dx, dw, None, None, None, None, None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor, x_hist: torch.Tensor,
            w_hist: torch.Tensor, g_hist: torch.Tensor,
            g_amax: Optional[torch.Tensor] = None,
            impl: str = "auto") -> torch.Tensor:
    """Quantized ``x @ w^T`` (``x`` [..., K], ``w`` [N, K]) in x's dtype
    with delayed scaling from the three rings; ``g_amax`` (a 0-d f32
    tensor) takes the max of itself and the backward's gradient amax
    (given one under autograd, the backward runs whenever the output's
    gradient is taken, as tpudl's ``g_probe`` makes it run).
    tpudl's ``fp8_dot`` also returns the forward amaxes: take them with
    ``amax`` (``Fp8Dense`` records them)."""
    native = resolve_impl(impl, x.device)
    probe = None
    if g_amax is not None and torch.is_grad_enabled():
        probe = torch.zeros((), device=x.device, requires_grad=True)
    return _Fp8Dot.apply(x, w, x_hist, w_hist, g_hist, g_amax, probe, native)


fp8_dot.launches_fwd = 0
fp8_dot.launches_dx = 0
fp8_dot.launches_dw = 0


def amax(t: torch.Tensor) -> torch.Tensor:
    """max |t| as a 0-d f32 tensor, outside autograd."""
    return t.detach().abs().max().float()


class Fp8Dense(nn.Module):
    """A projection whose product runs through ``fp8_dot`` (see the
    module docstring): ``weight`` ``[d_out, d_in]`` in ``weight_dtype``
    (f32 masters; a frozen LoRA base may store the compute dtype, which
    gives the same numbers), ``bias`` f32 when ``use_bias``, ``lora_a``
    ``[d_in, rank]`` and ``lora_b`` ``[rank, d_out]`` f32 when ``rank`` >
    0. ``y = fp8(x W^T) + ((x A) B) * (alpha / rank) + b``, each term in
    ``dtype``, in tpudl's order."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 use_bias: bool = True, rank: int = 0, alpha: float = 16.0,
                 amax_window: Optional[int] = None, impl: str = "auto",
                 weight_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.impl = dtype, impl
        self.rank, self.alpha = rank, alpha
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=weight_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            d_out, dtype=torch.float32, device=device)) if use_bias else None
        if rank > 0:
            self.lora_a = nn.Parameter(
                torch.empty(d_in, rank, dtype=torch.float32, device=device))
            self.lora_b = nn.Parameter(
                torch.empty(rank, d_out, dtype=torch.float32, device=device))
        window = amax_window or default_amax_window()
        for name in ("x_hist", "w_hist", "g_hist"):
            self.register_buffer(name, amax_history_init(window, device),
                                 persistent=False)
        for name in ("g_probe", "x_amax", "w_amax", "g_amax"):
            self.register_buffer(
                name, torch.zeros((), dtype=torch.float32, device=device),
                persistent=False)

    @property
    def rings(self):
        return {"x_hist": self.x_hist, "w_hist": self.w_hist,
                "g_hist": self.g_hist, "g_probe": self.g_probe}

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if torch.is_grad_enabled():
            self.x_amax.copy_(torch.maximum(self.x_amax, amax(x)))
            self.w_amax.copy_(torch.maximum(self.w_amax, amax(w)))
            g_amax = self.g_amax
        else:
            g_amax = None
        out = fp8_dot(x, w, self.x_hist, self.w_hist, self.g_hist, g_amax,
                      impl=self.impl)
        if self.rank > 0:
            delta = (x @ self.lora_a.to(self.dtype)) @ self.lora_b.to(
                self.dtype)
            out = out + delta * (self.alpha / self.rank)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


def fp8_sites(model: nn.Module):
    """(module name, Fp8Dense) of every fp8 site of ``model``."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, Fp8Dense)]


def fp8_state(model: nn.Module) -> Optional[dict]:
    """The rings of ``model``'s fp8 sites as a view in tpudl's ``"fp8"``
    collection layout (``{"bert": {"encoder": {"layer_0": {"attention":
    {"query": {"x_hist", "w_hist", "g_hist", "g_probe"}}}}}}``): the
    buffers themselves, so a restore into the view writes the model.
    None without sites."""
    sites = fp8_sites(model)
    if not sites:
        return None
    tree: dict = {}
    for name, site in sites:
        node = tree
        for key in name.split("."):
            node = node.setdefault(key, {})
        node.update(site.rings)
    return tree


@torch.no_grad()
def reset_fp8_state(model: nn.Module) -> None:
    """Fresh rings and observations at every fp8 site (all zeros)."""
    for _, site in fp8_sites(model):
        for t in (*site.rings.values(), site.x_amax, site.w_amax,
                  site.g_amax):
            t.zero_()


@torch.no_grad()
def zero_observations(model: nn.Module) -> None:
    """Clear the step's amax observations before its forward."""
    for _, site in fp8_sites(model):
        for t in (site.x_amax, site.w_amax, site.g_amax):
            t.zero_()


@torch.no_grad()
def advance_rings(model: nn.Module, ok: Optional[torch.Tensor] = None
                  ) -> None:
    """Advance every site's rings with the step's observations, in
    place; ``ok`` (a device bool, the loss-scale finite flag) gates the
    update: a skipped step advances nothing (tpudl's
    ``updated_fp8_state``)."""
    for _, site in fp8_sites(model):
        for hist, obs in ((site.x_hist, site.x_amax),
                          (site.w_hist, site.w_amax),
                          (site.g_hist, site.g_amax)):
            new = update_amax_history(hist, obs)
            hist.copy_(new if ok is None else torch.where(ok, new, hist))
