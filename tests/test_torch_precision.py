"""The port's mixed precision and fp8 training (tpudl_torch.train.precision,
tpudl_torch.ops.fp8_dot, tpudl_torch.rules) against tpudl's on the CPU,
case by case the counterpart of tests/test_precision.py.

tpudl runs its tiny BERT (``tests/test_precision.py``'s config) with
``fp8_train="reference"`` (fp8 values dequantized to f32 before the
dot); the port runs the same weights (``params_from_tpudl``) on CPU
tensors, where the fp8 product is its plain version, the same
arithmetic. Both train with the same SGD (tpudl.train.optim and the
port's optimizer, which follow optax alike): Adam would turn the
bf16-rounding noise of near-zero gradients into full-size steps, SGD
keeps the parameters' differences the size of the gradients'.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.config import OptimConfig as JOptimConfig
from tpudl.models.bert import BertConfig as JBertConfig
from tpudl.models.bert import BertForSequenceClassification as JBert
from tpudl.train import create_train_state as jcreate
from tpudl.train import make_classification_eval_step as jeval_step
from tpudl.train import make_classification_train_step as jtrain_step
from tpudl.train import precision as jprecision
from tpudl.train.optim import make_optimizer as jmake_optimizer
from tpudl_torch import rules
from tpudl_torch.config import OptimConfig
from tpudl_torch.models import bert
from tpudl_torch.rng import fold_in
from tpudl_torch.train import (
    LossScaleConfig,
    compile_step,
    create_train_state,
    fit,
    make_classification_eval_step,
    make_classification_train_step,
    make_optimizer,
    policy,
)
from tpudl_torch.train import precision as precision_mod

jfp8 = importlib.import_module("tpudl.ops.fp8_dot")
fp8 = importlib.import_module("tpudl_torch.ops.fp8_dot")

SEQ = 8
BATCH = 8
STEPS = 6
_KEYS = ("input_ids", "attention_mask")
_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=16, num_labels=2,
            hidden_dropout=0.0, attention_dropout=0.0)
_OPTIM = dict(name="sgd", learning_rate=0.2, warmup_steps=0,
              schedule="constant", grad_clip_norm=None, weight_decay=1e-4)
#: name -> (policy, fp8_train)
_CELLS = {"legacy": (None, False), "f32": ("f32", False),
          "bf16": ("bf16", False), "fp8": ("fp8", True)}
#: Parity bands against tpudl, (loss atol, parameter rtol, atol). f32:
#: summation order only. bf16 / fp8: the two packages round to bf16 at
#: other places (tpudl's XLA sums a bf16 embedding table's rows in bf16,
#: the port's one-hot product and embedding backward in f32; measured
#: at most 2.6e-3 on the token-type row after six steps), and fp8 adds
#: quantization buckets that such differences can flip.
_TOL = {"legacy": (1e-6, 2e-3, 2e-5), "f32": (1e-6, 2e-3, 2e-5),
        "bf16": (1e-3, 1e-2, 5e-3), "fp8": (1e-3, 1e-2, 5e-3)}
#: The rings: x and w hold amaxes of bf16 activations and weights (5 %);
#: g went through e5m2 products, two mantissa bits (a step of 25 %).
_RING_RTOL = {"x_hist": 5e-2, "w_hist": 5e-2, "g_hist": 0.25, "g_probe": 0}
BF16_BAND = 0.03
FP8_BAND = 0.08


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n=STEPS, seed=7, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(1, 64, (batch, SEQ)).astype(np.int32),
             "attention_mask": np.ones((batch, SEQ), np.int32),
             "label": rng.integers(0, 2, (batch,)).astype(np.int32)}
            for _ in range(n)]


def _jstate(prec, fp8_train):
    cfg = JBertConfig(**_CFG, dtype=jnp.float32,
                      fp8_train="reference" if fp8_train else False)
    if prec is not None:
        cfg = jprecision.resolve_policy(prec).configure_model(cfg)
    return jcreate(jax.random.key(0), JBert(cfg),
                   jnp.zeros((1, SEQ), jnp.int32),
                   jmake_optimizer(JOptimConfig(**_OPTIM)), precision=prec)


def _port_state(params, prec, fp8_train, **cfg_kw):
    cfg = bert.BertConfig(**dict(_CFG, **cfg_kw), dtype=torch.float32,
                          fp8_train=fp8_train)
    if prec is not None:
        cfg = precision_mod.resolve_policy(prec).configure_model(cfg)
    model = bert.BertForSequenceClassification(cfg, device="meta")
    return create_train_state(0, model, make_optimizer(OptimConfig(**_OPTIM)),
                              params=params, device="cpu", precision=prec)


def _drive(step, state, batches, rng=1):
    losses, metrics = [], None
    for batch in batches:
        state, metrics = step(state, batch, rng)
        losses.append(float(metrics["loss"]))
    return state, losses, metrics


def _flat(tree, prefix=""):
    """path -> numpy leaf of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v.detach().cpu().numpy()
                                              if isinstance(v, torch.Tensor)
                                              else v)
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def runs():
    """One six-step run per cell in each package, from tpudl's initial
    weights, shared by the module's tests."""
    if not _RUNS:
        batches = _batches()
        for name, (prec, fp8_train) in _CELLS.items():
            js = _jstate(prec, fp8_train)
            params = bert.params_from_tpudl(jax.tree.map(np.asarray, js.params),
                                            device="cpu")
            jstep = jax.jit(jtrain_step(input_keys=_KEYS, precision=prec))
            jfinal, jlosses, jmetrics = _drive(
                jstep, js,
                [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                jax.random.key(1))
            state = _port_state(params, prec, fp8_train)
            step = compile_step(make_classification_train_step(
                input_keys=_KEYS, precision=prec), state, precision=prec)
            state, losses, metrics = _drive(step, state, batches)
            _RUNS[name] = {"params0": params, "jstate": jfinal,
                           "jlosses": jlosses, "jmetrics": jmetrics,
                           "state": state, "losses": losses,
                           "metrics": metrics, "step": step}
    return _RUNS


# ---------------------------------------------------------------------------
# identity and parity
# ---------------------------------------------------------------------------


def test_f32_policy_bitwise_identical_to_legacy(runs):
    """policy("f32") is the identity: the same losses and final
    parameters, bit for bit."""
    assert runs["legacy"]["losses"] == runs["f32"]["losses"]
    a = runs["legacy"]["state"].model.state_dict()
    b = runs["f32"]["state"].model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert runs["legacy"]["state"].precision is None
    assert runs["f32"]["state"].precision is None


@pytest.mark.parametrize("cell", list(_CELLS))
def test_policy_runs_match_tpudl(runs, cell):
    """Six steps of each cell against tpudl's same policy: losses,
    final parameters (bands ``_TOL``), the f32 masters, and under fp8 the
    rings (``_RING_RTOL``) and the loss-scale state (exact)."""
    run = runs[cell]
    loss_tol, rtol, atol = _TOL[cell]
    np.testing.assert_allclose(run["losses"], run["jlosses"], rtol=0,
                               atol=loss_tol)
    got = run["state"].model.state_dict()
    want = bert.params_from_tpudl(
        jax.tree.map(np.asarray, run["jstate"].params), device="cpu")
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    jprec, prec = run["jstate"].precision, run["state"].precision
    if jprec is None:
        assert prec is None
        return
    jflat, flat = _flat(jprec), _flat(prec)
    assert jflat.keys() == flat.keys()
    for key, w in jflat.items():
        g = flat[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        kind = key.rsplit("/", 1)[1]
        if key.startswith("/loss_scale"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=_RING_RTOL[kind], atol=0,
                                       err_msg=key)
    for k in ("loss_scale", "grad_skipped"):
        assert float(run["metrics"][k]) == float(run["jmetrics"][k])


def test_bf16_and_fp8_bands_against_the_f32_control(runs):
    """tpudl's own gates, on the port: bf16 and fp8 land within their
    bands of the f32 control, diverge from it somewhere (the cast
    happened), every ring advanced with positive amaxes in all three
    classes, no step skipped and the scale sits at 2^15."""
    control = runs["legacy"]["losses"]
    assert abs(runs["bf16"]["losses"][-1] - control[-1]) <= BF16_BAND
    assert abs(runs["fp8"]["losses"][-1] - control[-1]) <= FP8_BAND
    assert runs["bf16"]["losses"] != control
    metrics = runs["fp8"]["metrics"]
    assert float(metrics["loss_scale"]) == 2.0**15
    assert float(metrics["grad_skipped"]) == 0.0
    flat = _flat(runs["fp8"]["state"].precision["fp8"])
    for kind in ("x_hist", "w_hist", "g_hist"):
        hists = [v for k, v in flat.items() if k.endswith(kind)]
        assert len(hists) == 6 * 2, kind
        assert all(h[:STEPS].min() > 0 and h[STEPS:].max() == 0
                   for h in hists), kind


def test_bf16_matmuls_run_in_bf16(runs):
    """The compute dtype lands: under the bf16 policy the encoder's
    products take bf16 operands; f32 ones are only the classifier's and
    the token-type lookup (a one-hot product from the f32 table, which
    the step's cast would make bf16)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Dots(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default):
                seen.append(tuple(a.dtype for a in args
                                  if isinstance(a, torch.Tensor)))
            return func(*args, **(kwargs or {}))

    state = runs["bf16"]["state"]
    batch = {k: torch.as_tensor(v) for k, v in _batches(1)[0].items()}
    with Dots(), torch.no_grad():
        state.model(batch["input_ids"], batch["attention_mask"])
    bf16 = sum(all(d == torch.bfloat16 for d in s) for s in seen)
    f32 = sum(all(d == torch.float32 for d in s) for s in seen)
    assert bf16 >= 10 and f32 == 2 and len(seen) == bf16 + f32, seen


def test_annotate_matches_tpudl():
    """The rules engine on the port's names (through the models' inverse
    bridges) annotates each leaf as tpudl's engine annotates the same
    leaf: BERT, and a LoRA Llama; an uncovered leaf raises in both."""
    from tpudl import rules as jrules
    from tpudl.models import llama as jllama
    from tpudl_torch.models import llama

    cases = []
    jtree = jax.tree.map(np.asarray, _jstate(None, False).params)
    cases.append((jtree, bert.params_from_tpudl(jtree, device="cpu"),
                  bert.tpudl_path))
    lcfg = dict(vocab_size=64, num_labels=2, lora_rank=2, max_seq_len=32)
    ltree = jax.tree.map(np.asarray, jllama.LlamaForSequenceClassification(
        jllama.LLAMA_TINY(**lcfg)).init(jax.random.key(0),
                                         jnp.zeros((1, 4), jnp.int32))["params"])
    cases.append((ltree, llama.params_from_tpudl(ltree, device="cpu"),
                  llama.tpudl_path))
    for jtree, params, path in cases:
        for rule_set in (jprecision.DEFAULT_CAST_RULES,
                         ((r"lora_(a|b)$", "adapter"), (r"scale$", "norm"),
                          (r".*", None))):
            want = {}
            ann = jrules.annotate(rule_set, jtree)
            for p, v in jax.tree_util.tree_flatten_with_path(
                    ann, is_leaf=lambda x: x is None)[0]:
                want[jrules.path_str(p)] = v
            got = rules.annotate(rule_set, params, path=path)
            assert {path(k): v for k, v in got.items()} == want
        with pytest.raises(ValueError, match="no rule matches"):
            rules.annotate(((r"kernel$", "compute"),), params, path=path)
        with pytest.raises(ValueError, match="no rule matches"):
            jrules.annotate(((r"kernel$", "compute"),), jtree)
    with pytest.raises(NotImplementedError, match="item 7"):
        rules.match_partition_rules((), {})


def test_cast_params_rule_classes(runs):
    """bf16 cast rules: kernels and embedding tables cast, norm scales
    and biases keep f32."""
    params = dict(runs["legacy"]["state"].model.named_parameters())
    cast = policy("bf16").cast_params(params, bert.tpudl_path)
    n_bf16 = n_f32 = 0
    for name, leaf in cast.items():
        if bert.tpudl_path(name).endswith(("kernel", "embedding")):
            assert leaf.dtype == torch.bfloat16, name
            n_bf16 += 1
        else:
            assert leaf.dtype == torch.float32 and leaf is params[name], name
            n_f32 += 1
    assert n_bf16 > 10 and n_f32 > 10


# ---------------------------------------------------------------------------
# fp8 units against tpudl's
# ---------------------------------------------------------------------------


def _cast_inputs(dtype_max, torch_dtype, rng):
    """Every finite value of the format, the midpoints between
    neighbours (ties) and their f32 neighbours, normal draws across the
    range, subnormal-sized draws and values past the max."""
    codes = torch.arange(256, dtype=torch.uint8).view(torch_dtype).float()
    vals = np.unique(codes.numpy()[np.isfinite(codes.numpy())])
    mids = ((vals[1:] + vals[:-1]) / 2).astype(np.float32)
    parts = [vals, mids, np.nextafter(mids, np.float32(np.inf)),
             np.nextafter(mids, np.float32(-np.inf)),
             rng.normal(0, dtype_max / 4, 4000), rng.normal(0, 1e-3, 4000),
             np.array([dtype_max * 1.5, -dtype_max * 3, 1e30, -1e30])]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_cast_matches_tpudl_bitwise(fmt):
    """``_cast_fp8`` against tpudl's, bit for bit, at scale 1 and at a
    scale with a long mantissa (the f32 division before the clip and
    the cast): torch and ml_dtypes round alike, ties to even included."""
    jd, td, mx = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn,
                           fp8.E4M3_MAX),
                  "e5m2": (jnp.float8_e5m2, torch.float8_e5m2,
                           fp8.E5M2_MAX)}[fmt]
    x = _cast_inputs(mx, td, np.random.default_rng(0))
    for scale in (1.0, 0.3712):
        want = np.asarray(jfp8._cast_fp8(jnp.asarray(x), jnp.float32(scale),
                                         jd, mx)).view(np.uint8)
        got = fp8._cast_fp8(torch.from_numpy(x), torch.tensor(scale), td,
                            mx).view(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)


def test_fp8_dot_matches_tpudl():
    """The product, its gradients and the gradient amax against tpudl's
    ``impl="reference"``, from rings that give every tensor its own
    scale. The fp8 products' f32 sums are exact at these widths (a few
    mantissa bits a term), so the results agree to f32 rounding of the
    scale multiply (rtol 1e-6)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 6, 32)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(32, 16)) * 0.1).astype(np.float32)   # tpudl [K, N]
    hx = np.array([1.7, 0.4, 2.1, 0], np.float32)
    hw = np.array([0.3, 0.25, 0, 0], np.float32)
    hg = np.array([0.05, 0.2, 0, 0], np.float32)

    def jloss(x, w, probe):
        out, _, _ = jfp8.fp8_dot(x, w, hx, hw, hg, probe, impl="reference")
        return jnp.sum(out ** 2), out

    (jl, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.zeros(()))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w.T.copy()).requires_grad_()
    g_amax = torch.zeros(())
    out = fp8.fp8_dot(tx, tw, torch.from_numpy(hx), torch.from_numpy(hw),
                      torch.from_numpy(hg), g_amax)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jgrads[1]),
                               rtol=1e-6)
    assert float(g_amax) == pytest.approx(float(jgrads[2]), rel=1e-6)
    assert float(g_amax) > 0
    # A weight that needs no gradient gets no weight-gradient product.
    tw.requires_grad_(False)
    tx.grad = tw.grad = None
    fp8.fp8_dot(tx, tw, torch.from_numpy(hx), torch.from_numpy(hw),
                torch.from_numpy(hg)).sum().backward()
    assert tx.grad is not None and tw.grad is None
    # "fused" is the card's product: on a CPU tensor it raises.
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fp8.fp8_dot(tx, tw, torch.from_numpy(hx), torch.from_numpy(hw),
                    torch.from_numpy(hg), impl="fused")


def test_ring_functions_match_tpudl():
    """``update_amax_history`` (a nonfinite amax keeps the window's max)
    and ``history_scale`` (an all-zero ring scales by 1) against
    tpudl's."""
    hist = np.array([0.0, 3.0, 1.5, 0.0], np.float32)
    for amax in (2.5, np.inf, np.nan, 0.0, 7.0):
        want = jfp8.update_amax_history(jnp.asarray(hist), jnp.float32(amax))
        got = fp8.update_amax_history(torch.from_numpy(hist),
                                      torch.tensor(amax, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for ring in (hist, np.zeros(4, np.float32)):
        for mx in (fp8.E4M3_MAX, fp8.E5M2_MAX):
            assert float(fp8.history_scale(torch.from_numpy(ring), mx)) == \
                float(jfp8.history_scale(jnp.asarray(ring), mx))
    assert fp8.E4M3_MAX == jfp8.E4M3_MAX and fp8.E5M2_MAX == jfp8.E5M2_MAX


def test_fp8_saturation_clips_never_nans():
    """Values 448x past the window's scale saturate (clip before the
    cast) and the site records the true amax, which widens the next
    scale."""
    site = fp8.Fp8Dense(4, 4, torch.float32, use_bias=False, amax_window=4)
    with torch.no_grad():
        site.weight.copy_(torch.eye(4))
        site.x_hist.copy_(fp8.update_amax_history(site.x_hist,
                                                  torch.tensor(1.0)))
        site.w_hist.copy_(site.x_hist)
    x = torch.full((2, 4), 1000.0, requires_grad=True)
    out = site(x)
    assert bool(torch.isfinite(out).all())
    assert float(site.x_amax) == 1000.0
    fp8.advance_rings(site)
    assert float(fp8.history_scale(site.x_hist, fp8.E4M3_MAX)) == \
        pytest.approx(1000.0 / 448.0)


def test_amax_ring_rejects_nonfinite():
    hist = fp8.update_amax_history(fp8.amax_history_init(3),
                                   torch.tensor(5.0))
    poisoned = fp8.update_amax_history(hist, torch.tensor(float("inf")))
    assert bool(torch.isfinite(poisoned).all())
    assert float(poisoned[0]) == 5.0


# ---------------------------------------------------------------------------
# loss scaling and the skip step
# ---------------------------------------------------------------------------


def test_loss_scale_transitions_match_tpudl():
    """The growth streak, the backoff floor and the growth cap, step by
    step against tpudl's ``update_loss_scale``."""
    cfg = dict(init=4.0, growth_factor=2.0, backoff_factor=0.5,
               growth_interval=3, max_scale=16.0, min_scale=1.0)
    jcfg = jprecision.LossScaleConfig(**cfg)
    tcfg = LossScaleConfig(**cfg)
    jls = {"scale": jnp.float32(4.0), "growth_count": jnp.int32(0),
           "skipped": jnp.int32(0)}
    tls = {"scale": torch.tensor(4.0), "growth_count":
           torch.tensor(0, dtype=torch.int32),
           "skipped": torch.tensor(0, dtype=torch.int32)}
    flags = [True] * 10 + [False] * 6 + [True] * 4 + [False, True]
    seen = []
    for ok in flags:
        jls = jprecision.update_loss_scale(jls, jcfg, jnp.asarray(ok))
        tls = precision_mod.update_loss_scale(tls, tcfg, ok)
        for k in jls:
            assert tls[k].dtype == {"scale": torch.float32}.get(
                k, torch.int32)
            assert tls[k].item() == np.asarray(jls[k]).item(), (k, ok)
        seen.append(tls["scale"].item())
    # The run reached the cap and the floor.
    assert max(seen) == 16.0 and min(seen) == 1.0
    assert tls["skipped"].item() == 7


def _poison(state):
    """Set one weight to inf: BERT's position table (what tpudl's test
    poisons, its first 2-D leaf; position 0 is in every row, and an fp8
    site's weight would saturate instead), else the first parameter of 2
    or more dimensions. Returns the name and the old value."""
    params = dict(state.model.named_parameters())
    name = next((n for n in params if "position_embeddings" in n),
                next(n for n, p in params.items() if p.dim() >= 2))
    p = params[name]
    old = p.detach().clone()
    with torch.no_grad():
        p[0, 0] = float("inf")
    return name, old


def _snapshot(state):
    out = {f"p/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"o/{k}/{n}": t.clone() for n, t in v.items()})
        elif isinstance(v, torch.Tensor) and k != "scalars":
            out[f"o/{k}"] = v.clone()
    out.update({f"r{k}": torch.from_numpy(v.copy())
                for k, v in _flat(state.precision["fp8"]).items()})
    return out, state.step, state.opt_state["host_count"]


@pytest.mark.parametrize("compiled", [False, True])
def test_nonfinite_grad_skips_step(compiled):
    """A nonfinite gradient skips the step: parameters, optimizer state
    (``count`` included), ``step``, ``host_count`` and the rings stay bit
    for bit; the scale halves, the streak resets, ``skipped`` counts it.
    With dropout on, the retried step (weight put back) draws the masks
    the skipped one drew: its loss equals a control run's, bit for bit.
    (``compile_step`` runs a CPU state eagerly; the captured step is held
    to the same on the card, tests/test_torch_kernels_cuda.py.)"""
    params = bert.params_from_tpudl(
        jax.tree.map(np.asarray, _jstate(None, False).params), device="cpu")
    batches = _batches(4)

    def make():
        st = _port_state(params, "fp8", True, hidden_dropout=0.1,
                         attention_dropout=0.1)
        step = make_classification_train_step(input_keys=_KEYS,
                                              precision="fp8")
        if compiled:
            step = compile_step(step, st, precision="fp8")
        st, _, _ = _drive(step, st, batches[:2], rng=5)
        return st, step

    control, cstep = make()
    state, step = make()
    name, old = _poison(state)
    before, step_no, host_count = _snapshot(state)
    seeds = make_classification_train_step(input_keys=_KEYS).seeds(state, 5)
    state, metrics = step(state, batches[2], 5)
    assert float(metrics["grad_skipped"]) == 1.0
    assert float(metrics["loss_scale"]) == 2.0**15
    after, step_after, count_after = _snapshot(state)
    assert step_after == step_no and count_after == host_count
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    ls = state.precision["loss_scale"]
    assert float(ls["scale"]) == 2.0**14
    assert int(ls["growth_count"]) == 0 and int(ls["skipped"]) == 1
    with torch.no_grad():
        dict(state.model.named_parameters())[name].copy_(old)
    assert make_classification_train_step(input_keys=_KEYS).seeds(
        state, 5) == seeds
    state, metrics = step(state, batches[2], 5)
    control, cmetrics = cstep(control, batches[2], 5)
    assert float(metrics["grad_skipped"]) == 0.0
    assert torch.equal(metrics["loss"], cmetrics["loss"])
    assert state.step == control.step == 3


def test_batch_stats_restored_on_a_skipped_step():
    """A BatchNorm model under a loss-scaling policy: the statistics the
    skipped step's forward moved are put back."""
    from tpudl_torch.data.synthetic import synthetic_classification_batches
    from tpudl_torch.models.resnet import ResNetTiny

    model = ResNetTiny(num_classes=4, dtype=torch.float32, device="meta")
    pol = dataclasses.replace(policy("f32"), loss_scale=LossScaleConfig())
    state = create_train_state(0, model, make_optimizer(OptimConfig(**_OPTIM)),
                               device="cpu", precision=pol)
    step = make_classification_train_step(precision=pol)
    batch = next(iter(synthetic_classification_batches(
        8, image_shape=(16, 16, 3), num_classes=4, num_batches=1)))
    state, m = step(state, batch, 0)
    assert float(m["grad_skipped"]) == 0.0 and state.step == 1
    stats = {k: v.clone() for k, v in state.batch_stats.items()}
    _poison(state)
    state, m = step(state, batch, 0)
    assert float(m["grad_skipped"]) == 1.0 and state.step == 1
    for k, v in state.batch_stats.items():
        assert torch.equal(v, stats[k]), k


def test_fused_loss_backward_is_finite_at_scale():
    """The fused cross-entropy's backward receives the scaled upstream
    gradient: at scale 2^15 its f32 path (the plain version here, the
    kernel on the card) stays finite and is the unscaled gradient times
    the scale, exactly (a power of two)."""
    from tpudl_torch.ops.cross_entropy import softmax_cross_entropy

    logits = torch.randn(16, 30, generator=torch.Generator().manual_seed(0))
    labels = torch.randint(0, 30, (16,))
    grads = []
    for scale in (1.0, 2.0**15):
        x = logits.clone().requires_grad_()
        (softmax_cross_entropy(x, labels, impl="auto").mean() * scale
         ).backward()
        grads.append(x.grad)
    assert bool(torch.isfinite(grads[1]).all())
    assert torch.equal(grads[1], grads[0] * 2.0**15)


# ---------------------------------------------------------------------------
# seams: moments, eval, validation, accumulation, remat, telemetry
# ---------------------------------------------------------------------------


def test_moment_rules_bitwise_match_mu_dtype():
    """``policy(..., bf16_moments=True)``'s rule-selected bf16 first
    moments are ``OptimConfig(mu_dtype="bfloat16")`` bit for bit: the
    stored moments, the second moments and the parameters over three
    AdamW steps; the moments really store bf16."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "a.bias": (3,), "b.weight": (3, 2)}
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=0, schedule="constant")
    runs = []
    for mu_dtype, pol in (("bfloat16", None),
                          ("float32", policy("bf16", bf16_moments=True))):
        tx = make_optimizer(OptimConfig(mu_dtype=mu_dtype, **kw))
        params = {k: v.clone() for k, v in p0.items()}
        state = tx.init(params, mu_dtypes=None if pol is None
                        else pol.moment_dtypes(params))
        for i in range(3):
            tx.apply_(params, {k: v * 0.5 + 0.01 * i
                               for k, v in params.items()}, state)
        runs.append((params, state))
    (pa, sa), (pb, sb) = runs
    for k in p0:
        assert sb["mu"][k].dtype == torch.bfloat16
        for a, b in ((pa[k], pb[k]), (sa["mu"][k], sb["mu"][k]),
                     (sa["nu"][k], sb["nu"][k])):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    # Through the train state: every trainable leaf's moment is bf16.
    state = create_train_state(
        0, bert.BertForSequenceClassification(bert.BertConfig(**_CFG),
                                              device="meta"),
        make_optimizer(OptimConfig(**kw)), device="cpu",
        precision=policy("bf16", bf16_moments=True))
    assert {m.dtype for m in state.opt_state["mu"].values()} == {torch.bfloat16}
    assert {m.dtype for m in state.opt_state["nu"].values()} == {torch.float32}


def test_eval_step_reads_the_rings(runs):
    """The eval step quantizes with the trained rings and records
    nothing; its metrics are tpudl's eval step's on its own fp8 state
    (the two states differ by the bands above), and a forward with
    zeroed rings gives other logits."""
    run = runs["fp8"]
    state, batch = run["state"], _batches(1, seed=11)[0]
    rings = _flat(state.precision["fp8"])
    metrics = make_classification_eval_step(input_keys=_KEYS)(state, batch)
    assert all(np.array_equal(v, _flat(state.precision["fp8"])[k])
               for k, v in rings.items())
    jm = jax.jit(jeval_step(input_keys=_KEYS))(
        run["jstate"], {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               atol=2e-3)
    ids, mask = (torch.as_tensor(batch[k]) for k in _KEYS)
    with torch.no_grad():
        trained = state.model(ids, mask)
        saved = {k: t.clone() for k, t in state.model.named_buffers()}
        fp8.reset_fp8_state(state.model)
        fresh = state.model(ids, mask)
        for k, t in state.model.named_buffers():
            t.copy_(saved[k])
    assert not torch.equal(trained, fresh)


def test_validation_errors(runs):
    legacy = runs["legacy"]["state"]
    with pytest.raises(ValueError, match="loss-scale state"):
        compile_step(make_classification_train_step(precision="fp8"), legacy,
                     precision="fp8")
    no_fp8 = dataclasses.replace(policy("fp8"), loss_scale=None)
    with pytest.raises(ValueError, match="amax state"):
        compile_step(make_classification_train_step(precision=no_fp8),
                     legacy, precision=no_fp8)
    with pytest.raises(ValueError, match="fp8_train"):
        create_train_state(0, bert.BertForSequenceClassification(
            bert.BertConfig(**_CFG), device="meta"),
            make_optimizer(OptimConfig(**_OPTIM)), device="cpu",
            precision="fp8")
    with pytest.raises(ValueError, match="mutually exclusive"):
        bert.BertForSequenceClassification(bert.BertConfig(
            **_CFG, fp8_train=True, weight_dtype="int8"), device="meta")
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM

    with pytest.raises(ValueError, match="does not compose"):
        LlamaForCausalLM(LLAMA_TINY(fp8_train=True, weight_dtype="int8"),
                         device="meta")
    with pytest.raises(ValueError, match="unknown precision policy"):
        policy("fp4")
    with pytest.raises(ValueError, match="no dtype seam"):
        policy("bf16").configure_model(object())
    # "force" is the card's product: a CPU model refuses it.
    model = bert.BertForSequenceClassification(bert.BertConfig(
        **_CFG, fp8_train="force"), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        model(torch.ones(1, SEQ, dtype=torch.long))


def test_policy_from_env_and_knobs(monkeypatch):
    """TPUDL_TRAIN_PRECISION picks the preset; TPUDL_LOSS_SCALE_INIT and
    TPUDL_LOSS_SCALE_GROWTH_INTERVAL set the fp8 preset's loss scaling and
    TPUDL_FP8_AMAX_WINDOW the ring length of an Fp8Dense built after it,
    with tpudl's defaults."""
    from tpudl.train.precision import policy_from_env as jfrom_env

    for name in ("TPUDL_TRAIN_PRECISION", "TPUDL_FP8_AMAX_WINDOW",
                 "TPUDL_LOSS_SCALE_INIT", "TPUDL_LOSS_SCALE_GROWTH_INTERVAL"):
        monkeypatch.delenv(name, raising=False)
    assert precision_mod.policy_from_env() is None
    default = policy("fp8")
    jdefault = jprecision.policy("fp8")
    assert fp8.Fp8Dense(16, 16, torch.float32).x_hist.shape == (16,)
    assert jdefault.amax_window == 16
    assert dataclasses.asdict(default.loss_scale) == \
        dataclasses.asdict(jdefault.loss_scale)
    monkeypatch.setenv("TPUDL_TRAIN_PRECISION", "fp8")
    monkeypatch.setenv("TPUDL_FP8_AMAX_WINDOW", "4")
    monkeypatch.setenv("TPUDL_LOSS_SCALE_INIT", "1024")
    monkeypatch.setenv("TPUDL_LOSS_SCALE_GROWTH_INTERVAL", "7")
    pol, jpol = precision_mod.policy_from_env(), jfrom_env()
    assert pol.name == jpol.name == "fp8"
    assert jpol.amax_window == 4
    assert pol.loss_scale.init == jpol.loss_scale.init == 1024.0
    assert pol.loss_scale.growth_interval == 7
    site = fp8.Fp8Dense(16, 16, torch.float32)
    assert site.x_hist.shape == (4,)


def test_fp8_accumulation_max_combine(runs):
    """fp8 under accumulation: each batch doubled and split in two equal
    microbatches gives each microbatch the monolithic batch, so the
    max-combined observations are the monolithic step's and the run
    (losses, parameters, rings, loss-scale state) is the monolithic
    port run bit for bit; against tpudl's monolithic run, the fp8 bands."""
    run = runs["fp8"]
    doubled = [{k: np.concatenate([v, v]) for k, v in b.items()}
               for b in _batches()]
    state = _port_state(run["params0"], "fp8", True)
    step = make_classification_train_step(input_keys=_KEYS, precision="fp8",
                                          accum_steps=2)
    state, losses, _ = _drive(step, state, doubled)
    assert losses == run["losses"]
    mono = run["state"]
    for k, v in mono.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    a, b = _flat(state.precision), _flat(mono.precision)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    np.testing.assert_allclose(losses, run["jlosses"], atol=_TOL["fp8"][0])


def test_fp8_remat_gradients_bitwise_and_rings_once():
    """remat="layer" on the fp8 model with dropout: the recompute
    quantizes with the same scales and gives the same bits, so the
    gradients are bitwise those without remat; the observations are
    equal (max is idempotent: nothing is recorded twice), and the rings
    after a step are equal."""
    params = bert.params_from_tpudl(
        jax.tree.map(np.asarray, _jstate(None, False).params), device="cpu")
    batch = _batches(1)[0]
    out = {}
    for remat in (False, "layer"):
        state = _port_state(params, "fp8", True, hidden_dropout=0.1,
                            attention_dropout=0.1, remat=remat)
        step = make_classification_train_step(input_keys=_KEYS,
                                              precision="fp8")
        grads, metrics = step.grads_and_metrics(state, batch,
                                                fold_in(3, 0, "cpu"))
        obs = {f"{n}.{a}": getattr(m, a).clone()
               for n, m in fp8.fp8_sites(state.model)
               for a in ("x_amax", "w_amax", "g_amax")}
        state, _ = step(state, batch, 3)
        out[remat] = grads, metrics, obs, _flat(state.precision)
    (g0, m0, o0, r0), (g1, m1, o1, r1) = out[False], out["layer"]
    assert torch.equal(m0["loss"], m1["loss"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in o0:
        assert torch.equal(o0[k], o1[k]) and float(o0[k]) > 0, k
    assert all(np.array_equal(r0[k], r1[k]) for k in r0)


def test_fit_publishes_numerics_telemetry(runs):
    """fit publishes the precision state at its log cadence: the loss
    scale gauge, the skipped-step counter (by delta) and one drift
    observation per nonzero ring."""
    from tpudl_torch.obs import counters as obs_counters

    run = runs["fp8"]
    state = _port_state(run["params0"], "fp8", True)
    step = make_classification_train_step(input_keys=_KEYS, precision="fp8")
    reg = obs_counters.registry()
    reg.reset()
    fit(step, state, _batches(2), 1, log_every=2, logger=lambda n, m: None)
    assert reg.gauge("train_loss_scale").value == 2.0**15
    assert reg.counter("train_grad_skipped_total").value == 0
    assert reg.histogram("train_fp8_amax_drift").count == 3 * 12
    state.precision["loss_scale"]["skipped"].fill_(2)
    precision_mod.publish_numerics_telemetry(state.precision)
    precision_mod.publish_numerics_telemetry(state.precision)
    assert reg.counter("train_grad_skipped_total").value == 2
    precision_mod.publish_numerics_telemetry(None)
    reg.reset()


# ---------------------------------------------------------------------------
# Llama: the fp8 x LoRA cell and full-parameter training
# ---------------------------------------------------------------------------

_LLAMA = dict(vocab_size=64, num_labels=2, max_seq_len=32)


def _llama_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(1, 64, (4, 16)).astype(np.int32),
            "attention_mask": np.ones((4, 16), np.int32),
            "label": rng.integers(0, 2, (4,)).astype(np.int32)}


def test_fp8_lora_cell():
    """fp8_train x lora_rank on LLAMA_TINY: Fp8Dense carries LoRALinear's
    adapter leaves, so ``extract_adapters``, ``lora_param_labels`` and
    ``lora_optimizer`` see the same tree; the frozen base stores the
    compute dtype. Two fp8 steps (lora_b drawn nonzero) beside tpudl's
    fp8 policy over lora_optimizer: the first loss within 1e-3, the
    second within tpudl's fp8 band (0.08; this random tiny model's bf16
    gradients are dominated by cancellation: the layer-0 adapters'
    gradients part by up to 70 % between the packages in bf16 alone and
    by 1e-4 in f32, so Adam's first steps part too); the base unchanged
    bit for bit; the adapters moved; the rings advanced."""
    from tpudl.models import llama as jllama
    from tpudl.models.lora import lora_optimizer as jlora_optimizer
    from tpudl.train.loop import TrainState as JTrainState
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import (
        extract_adapters,
        lora_optimizer,
        lora_param_labels,
    )

    kw = dict(_LLAMA, lora_rank=2)
    model = llama.LlamaForSequenceClassification(
        llama.LLAMA_TINY(fp8_train=True, **kw), device="cpu")
    sd = model.state_dict()
    adapters = extract_adapters(sd)
    assert len(adapters) == 2 * 7
    for site in adapters.values():
        assert site["lora_a"].shape[-1] == 2
        assert not site["lora_b"].any()
    labels = set(lora_param_labels(sd, ("classifier",)).values())
    assert labels == {"train", "freeze"}
    assert sd["model.layer_0.up_proj.weight"].dtype == torch.bfloat16

    jmodel = jllama.LlamaForSequenceClassification(
        jprecision.policy("fp8").configure_model(
            jllama.LLAMA_TINY(fp8_train="reference", **kw)))
    batch = _llama_batch()
    jvars = jmodel.init(jax.random.key(0), jnp.asarray(batch["input_ids"]))
    rng = np.random.default_rng(4)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['lora_b']") else np.asarray(v),
        jvars["params"])
    ocfg = dict(learning_rate=1e-3, warmup_steps=0, schedule="constant")
    tx = jlora_optimizer(jmake_optimizer(JOptimConfig(**ocfg)), jparams,
                         ("classifier",))
    js = JTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, jparams),
        tx=tx, precision=jprecision.init_precision_state(
            jprecision.policy("fp8"), jvars["fp8"]))
    jstep = jax.jit(jtrain_step(input_keys=_KEYS, precision="fp8"))
    jlosses = []
    for _ in range(2):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(1))
        jlosses.append(float(m["loss"]))

    model = llama.LlamaForSequenceClassification(
        policy("fp8").configure_model(llama.LLAMA_TINY(fp8_train=True, **kw)),
        device="meta")
    tx = lora_optimizer(make_optimizer(OptimConfig(**ocfg)), model,
                        ("classifier",))
    state = create_train_state(
        0, model, tx, device="cpu", precision="fp8",
        params=llama.params_from_tpudl(jparams, dtype=torch.bfloat16,
                                       device="cpu"))
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    step = make_classification_train_step(input_keys=_KEYS, precision="fp8")
    state, losses, _ = _drive(step, state, [batch, batch])
    assert abs(losses[0] - jlosses[0]) <= _TOL["fp8"][0]
    assert abs(losses[1] - jlosses[1]) <= FP8_BAND
    for k, p in state.model.named_parameters():
        if p.requires_grad:
            assert not torch.equal(p, before[k]), k
        else:
            assert torch.equal(p, before[k]), k
    flat = _flat(state.precision["fp8"])
    assert len(flat) == 4 * 2 * 7
    bad = [k for k, v in flat.items() if k.endswith(("x_hist", "w_hist",
                                                      "g_hist"))
           and not (v[:2].min() > 0 and v[2:].max() == 0)]
    assert not bad, {k: flat[k][:3] for k in bad}


def test_fp8_lora_updates_match_tpudl():
    """The fp8 x LoRA backward against tpudl's, update by update: the fp8
    policy with an f32 compute dtype (so the two packages round alike
    and only the fp8 casts quantize) on LLAMA_TINY with rank-2 adapters
    (lora_b drawn nonzero), two SGD steps on two batches. Every adapter
    and classifier tensor's update (lr times its gradient, which reaches
    the layer-0 adapters through every Fp8Dense's dx) is held to
    tpudl's at a relative L2 error of 2e-2 in step 1 (every ring empty,
    scale 1; measured 8.8e-3) and 0.25 in step 2 (rings populated;
    measured 0.13: g is e5m2, two mantissa bits, so an element whose f32
    value differs by summation order between the packages can change by
    one 25 % bucket); the first loss within 1e-4 (measured 2.6e-5)."""
    from tpudl.models import llama as jllama
    from tpudl.models.lora import lora_optimizer as jlora_optimizer
    from tpudl.train.loop import TrainState as JTrainState
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import lora_optimizer

    kw = dict(_LLAMA, lora_rank=2)
    jpol = dataclasses.replace(jprecision.policy("fp8"),
                               compute_dtype=jnp.float32)
    pol = dataclasses.replace(policy("fp8"), compute_dtype=torch.float32)
    jmodel = jllama.LlamaForSequenceClassification(jpol.configure_model(
        jllama.LLAMA_TINY(fp8_train="reference", **kw)))
    batches = [_llama_batch(0), _llama_batch(1)]
    jvars = jmodel.init(jax.random.key(0),
                        jnp.asarray(batches[0]["input_ids"]))
    rng = np.random.default_rng(4)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.05 * rng.normal(size=v.shape)).astype(np.float32)
        if jax.tree_util.keystr(p).endswith("['lora_b']") else np.asarray(v),
        jvars["params"])
    ocfg = dict(name="sgd", learning_rate=0.01, warmup_steps=0,
                schedule="constant", grad_clip_norm=None, weight_decay=0.0)
    js = JTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree.map(jnp.asarray, jparams),
        tx=jlora_optimizer(jmake_optimizer(JOptimConfig(**ocfg)), jparams,
                           ("classifier",)),
        precision=jprecision.init_precision_state(jpol, jvars["fp8"]))
    jstep = jax.jit(jtrain_step(input_keys=_KEYS, precision=jpol))

    def bridged(params):
        return llama.params_from_tpudl(jax.tree.map(np.asarray, params),
                                       dtype=torch.float32, device="cpu")

    jparams_at, jlosses = [bridged(js.params)], []
    for batch in batches:
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(1))
        jlosses.append(float(m["loss"]))
        jparams_at.append(bridged(js.params))

    model = llama.LlamaForSequenceClassification(
        pol.configure_model(llama.LLAMA_TINY(fp8_train=True, **kw)),
        device="meta")
    tx = lora_optimizer(make_optimizer(OptimConfig(**ocfg)), model,
                        ("classifier",))
    state = create_train_state(0, model, tx, device="cpu", precision=pol,
                               params=jparams_at[0])
    step = make_classification_train_step(input_keys=_KEYS, precision=pol)
    trained = [k for k, p in state.model.named_parameters()
               if p.requires_grad]
    assert len(trained) == 2 * 2 * 7 + 2
    params_at, losses = [{k: state.params[k].detach().clone()
                          for k in trained}], []
    for batch in batches:
        state, m = step(state, batch, 1)
        losses.append(float(m["loss"]))
        params_at.append({k: state.params[k].detach().clone()
                          for k in trained})
    assert abs(losses[0] - jlosses[0]) <= 1e-4
    for s, band in ((1, 2e-2), (2, 0.25)):
        errs = {}
        for k in trained:
            ours = params_at[s][k] - params_at[s - 1][k]
            theirs = jparams_at[s][k] - jparams_at[s - 1][k]
            assert theirs.norm() > 0, k
            errs[k] = float((ours - theirs).norm() / theirs.norm())
        worst = max(errs, key=errs.get)
        assert errs[worst] <= band, (s, worst, errs[worst])


def test_full_parameter_llama_trains_every_parameter_like_tpudl():
    """LlamaForSequenceClassification with lora_rank=0 trains every
    parameter against f32 masters, as tpudl's does (the port used to
    train only the classifier over a frozen bf16 base): every parameter
    requires a gradient, stores f32 and moves; three AdamW steps from
    tpudl's weights (the llama3_8b_lora optimizer at a constant 1e-3;
    at 1e-2 Adam turns a few near-zero gradients' f32 summation-order
    differences into steps of 1e-4)
    match tpudl's at the port's Llama bands (loss rtol 1e-4 / atol 1e-5,
    parameters rtol 2e-3 / atol 2e-5). In bf16 the masters stay f32 and
    still all move. Under policy("bf16", bf16_moments=True) (the chip's
    llama1b_full_train policy) the first moments store bf16 and the
    three steps match tpudl's same policy: losses within 5e-3 (the two
    packages round to bf16 at other places; measured 1.4e-3) and every
    parameter within a relative L2 error of 2e-2 (measured 6.6e-3)."""
    from tpudl.config import get_config as jget
    from tpudl.models import llama as jllama
    from tpudl_torch.models import llama

    batch = _llama_batch(1)
    jmodel = jllama.LlamaForSequenceClassification(
        jllama.LLAMA_TINY(dtype=jnp.float32, **_LLAMA))
    ocfg = dataclasses.replace(jget("llama3_8b_lora").optim, warmup_steps=0,
                               schedule="constant", learning_rate=1e-3)
    js = jcreate(jax.random.key(0), jmodel, jnp.asarray(batch["input_ids"]),
                 jmake_optimizer(ocfg))
    params = llama.params_from_tpudl(jax.tree.map(np.asarray, js.params),
                                     dtype=torch.float32, device="cpu")
    jstep = jax.jit(jtrain_step(input_keys=_KEYS))
    jlosses = []
    for _ in range(3):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(1))
        jlosses.append(float(m["loss"]))
    for dtype in (torch.float32, torch.bfloat16):
        model = llama.LlamaForSequenceClassification(
            llama.LLAMA_TINY(dtype=dtype, **_LLAMA), device="meta")
        state = create_train_state(
            0, model, make_optimizer(OptimConfig(**dataclasses.asdict(ocfg))),
            params=params, device="cpu")
        names = {k for k, _ in model.named_parameters()}
        assert set(state.params) == names == set(params)
        assert all(p.dtype == torch.float32 for p in state.params.values())
        before = {k: v.clone() for k, v in state.params.items()}
        step = make_classification_train_step(input_keys=_KEYS)
        state, losses, _ = _drive(step, state, [batch] * 3)
        moved = [k for k, v in state.params.items()
                 if not torch.equal(v, before[k])]
        assert sorted(moved) == sorted(names)
        if dtype == torch.float32:
            np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
            want = llama.params_from_tpudl(jax.tree.map(np.asarray, js.params),
                                           dtype=torch.float32, device="cpu")
            for k, w in want.items():
                np.testing.assert_allclose(state.params[k].detach().numpy(),
                                           w.numpy(),
                                           rtol=2e-3, atol=2e-5, err_msg=k)

    pol = policy("bf16", bf16_moments=True)
    jpol = jprecision.policy("bf16", bf16_moments=True)
    js = jcreate(jax.random.key(0), jllama.LlamaForSequenceClassification(
        jpol.configure_model(jllama.LLAMA_TINY(dtype=jnp.float32, **_LLAMA))),
        jnp.asarray(batch["input_ids"]), jmake_optimizer(ocfg),
        precision=jpol)
    jstep = jax.jit(jtrain_step(input_keys=_KEYS, precision=jpol))
    jlosses = []
    for _ in range(3):
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.key(1))
        jlosses.append(float(m["loss"]))
    model = llama.LlamaForSequenceClassification(
        pol.configure_model(llama.LLAMA_TINY(dtype=torch.float32, **_LLAMA)),
        device="meta")
    state = create_train_state(
        0, model, make_optimizer(OptimConfig(**dataclasses.asdict(ocfg))),
        params=params, device="cpu", precision=pol)
    assert {t.dtype for t in state.opt_state["mu"].values()} == \
        {torch.bfloat16}
    step = make_classification_train_step(input_keys=_KEYS, precision=pol)
    state, losses, _ = _drive(step, state, [batch] * 3)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=5e-3)
    want = llama.params_from_tpudl(jax.tree.map(np.asarray, js.params),
                                   dtype=torch.float32, device="cpu")
    assert all(p.dtype == torch.float32 for p in state.params.values())
    errs = {k: float((state.params[k].detach() - w).norm() / w.norm())
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-2, (worst, errs[worst])
