"""The port's training stack against tpudl's on the CPU: the optimizer
(against optax through tpudl.train.optim), dropout (by distribution —
the bits are the port's own), the synthetic data, and ``fit`` on a tiny
BERT."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.config import OptimConfig as JOptimConfig
from tpudl.data import synthetic as jsynthetic
from tpudl.ops import dropout as jdropout
from tpudl.train import optim as joptim
from tpudl_torch.config import OptimConfig, get_config
from tpudl_torch.data import synthetic
from tpudl_torch.ops import dropout
from tpudl_torch.train import optim
from tpudl_torch.train.loop import (
    create_train_state,
    cross_entropy_loss,
    fit,
    make_classification_train_step,
)

_SHAPES = {"w": (7, 5), "b": (5,), "e": (3, 4, 2)}


def _grads(step, scale, seed=0):
    rng = np.random.default_rng(seed * 1000 + step)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in _SHAPES.items()}


def _find(state, attr):
    """The first optax sub-state holding ``attr`` (e.g. ScaleByAdamState.mu)."""
    if hasattr(state, attr):
        return getattr(state, attr)
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find(s, attr)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("name,mu_dtype", [("adamw", "float32"),
                                           ("adamw", "bfloat16"),
                                           ("sgd", "float32")])
@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("clip_hit", [False, True])
def test_optimizer_matches_optax_over_ten_steps(name, mu_dtype, schedule,
                                                clip_hit):
    """Ten updates from fixed gradients, warmup included: with an f32
    first moment the parameters agree to 1e-6 relative; with a bf16 one
    the stored moment agrees to one bf16 step and the parameters to the
    same 1e-6 (the update uses the unrounded f32 moment in both)."""
    kw = dict(name=name, learning_rate=0.1, warmup_steps=3, total_steps=10,
              weight_decay=0.01, mu_dtype=mu_dtype, grad_clip_norm=1.0,
              schedule=schedule)
    jtx = joptim.make_optimizer(JOptimConfig(**kw))
    ttx = optim.make_optimizer(OptimConfig(**kw))
    rng = np.random.default_rng(42)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in _SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    # Compiled, as tpudl's train step runs it (eager JAX rounds b1 * mu to
    # bf16 where the compiled program keeps it in f32).
    jupdate = jax.jit(jtx.update)
    # Global norm ~0.2 (clipping not hit) or ~20 (hit).
    scale = 4.0 if clip_hit else 0.04
    for step in range(10):
        g = _grads(step, scale)
        updates, jstate = jupdate({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        tstate = ttx.apply_(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                            tstate)
        for k in _SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} param {k}")
    assert tstate["count"] == 10
    if name == "adamw":
        jmu = _find(jstate, "mu")
        for k in _SHAPES:
            got = tstate["mu"][k]
            assert got.dtype == {"float32": torch.float32,
                                 "bfloat16": torch.bfloat16}[mu_dtype]
            want = np.asarray(jmu[k], np.float32)
            # One step of the stored dtype (2^-8 relative for bf16).
            rtol = 2.0 ** -8 if mu_dtype == "bfloat16" else 1e-6
            np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                       atol=1e-7)


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_schedules_match_optax(schedule):
    cfg = dict(learning_rate=0.3, warmup_steps=4, total_steps=20,
               schedule=schedule)
    jsched = joptim.make_schedule(JOptimConfig(**cfg))
    tsched = optim.make_schedule(OptimConfig(**cfg))
    for count in range(25):
        np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                   rtol=1e-6, atol=1e-8)


def test_sst2_config_matches_tpudl():
    from tpudl.config import get_config as jget

    want, got = jget("sst2_bert_base"), get_config("sst2_bert_base")
    assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
    for field in ("model", "dataset", "global_batch_size", "seq_len",
                  "num_classes", "num_steps", "seed"):
        assert getattr(got, field) == getattr(want, field)


def test_synthetic_batches_match_tpudl():
    got = list(synthetic.synthetic_token_batches(4, 16, 100, num_batches=3))
    want = list(jsynthetic.synthetic_token_batches(4, 16, 100, num_batches=3))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    img = next(synthetic.synthetic_classification_batches(2, (8, 8, 3), 4))
    jimg = next(jsynthetic.synthetic_classification_batches(2, (8, 8, 3), 4))
    np.testing.assert_array_equal(img["image"], jimg["image"])
    on = synthetic.to_device(got[0], "cpu")
    assert on["input_ids"].dtype == torch.int32
    assert torch.equal(on["label"], torch.from_numpy(got[0]["label"]))


@pytest.mark.parametrize("rate", [0.0, 0.001, 0.1, 0.5, 0.999, 1.0])
def test_quantized_rate_matches_tpudl(rate):
    for exact in (False, True):
        assert dropout.quantized_rate(rate, exact) == jdropout.quantized_rate(
            rate, exact)


@pytest.mark.parametrize("rate,exact", [(0.1, False), (0.3, False),
                                        (0.1, True)])
def test_dropout_statistics(rate, exact):
    """Over 1 M draws the keep share lies within 4 sigma of 1 - the
    effective rate, and the output's mean within 4 sigma of the input."""
    n = 1_000_000
    g = torch.Generator().manual_seed(123)
    eff = dropout.quantized_rate(rate, exact)
    keep = dropout.dropout_keep_mask(g, (n,), rate, exact=exact, device="cpu")
    share = keep.float().mean().item()
    sigma = np.sqrt(eff * (1 - eff) / n)
    assert abs(share - (1 - eff)) < 4 * sigma
    x = torch.ones(n)
    out = dropout.dropout(g, x, rate, exact)
    assert set(torch.unique(out).tolist()) <= {
        0.0, float(np.float32(1.0) / np.float32(1.0 - eff))}
    out_sigma = np.sqrt(eff / (1 - eff) / n)
    assert abs(out.mean().item() - 1.0) < 4 * out_sigma


def test_dropout_edge_rates_and_module():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1000)
    assert dropout.dropout(g, x, 0.0) is x
    assert torch.equal(dropout.dropout(g, x, 1.0), torch.zeros_like(x))
    # round(0.001 * 256) == 0: nothing is dropped and nothing rescaled.
    assert torch.equal(dropout.dropout(g, x, 0.001), x)
    # 0.999 quantizes to 255/256: rare keeps, rescaled by 256.
    out = dropout.dropout(g, torch.ones(100_000), 0.999)
    assert set(torch.unique(out).tolist()) <= {0.0, 256.0}
    m = dropout.Dropout(0.1)
    assert m(x, deterministic=True) is x
    with pytest.raises(ValueError, match="Generator"):
        m(x, deterministic=False)
    bf = dropout.dropout(g, x.bfloat16(), 0.1)
    assert bf.dtype == torch.bfloat16
    # Same generator seed, same mask, whatever the dtype.
    a = dropout.dropout(torch.Generator().manual_seed(5), x, 0.1)
    b = dropout.dropout(torch.Generator().manual_seed(5), x.double(), 0.1)
    assert torch.equal(a == 0, b == 0)


def test_cross_entropy_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(6,))
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(labels)).mean()
    np.testing.assert_allclose(float(cross_entropy_loss(tl, tlab)), float(want),
                               rtol=1e-6)
    smooth = optax.softmax_cross_entropy(
        jnp.asarray(logits),
        optax.smooth_labels(jax.nn.one_hot(labels, 5), 0.1)).mean()
    np.testing.assert_allclose(float(cross_entropy_loss(tl, tlab, 0.1)),
                               float(smooth), rtol=1e-6)
    # The fused kernel takes CUDA tensors; "auto" on the CPU is the composite.
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cross_entropy_loss(tl, tlab, impl="fused")
    assert torch.equal(cross_entropy_loss(tl, tlab, impl="auto"),
                       cross_entropy_loss(tl, tlab))


def test_train_metrics_match_tpudl():
    from tpudl.train import metrics as jmetrics
    from tpudl_torch.train import metrics

    flops = metrics.transformer_train_flops(109_483_778, 256 * 128)
    assert flops == jmetrics.transformer_train_flops(109_483_778, 256 * 128)
    assert metrics.mfu(flops, 0.12, peak_per_chip=989e12) == jmetrics.mfu(
        flops, 0.12, peak_per_chip=989e12)
    # The meter skips the warm-up steps and times the rest.
    for warmup, steps, measured in ((2, 5, 3), (0, 4, 4), (3, 2, 0)):
        ours, theirs = (m.Throughput(32, warmup=warmup)
                        for m in (metrics, jmetrics))
        for _ in range(steps):
            ours.step(torch.zeros(()))
            theirs.step()
        got, want = ours.result(torch.zeros(())), theirs.result()
        assert got["steps_measured"] == want["steps_measured"] == measured
        assert got.keys() == want.keys()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            metrics.device_peak_flops()


def _tiny_bert_state(device="cpu"):
    """tests/test_bert.py:156-190's config: the task a tiny BERT learns."""
    from tpudl_torch.models.bert import BertConfig, BertForSequenceClassification

    cfg = BertConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128, max_position_embeddings=64,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     dtype=torch.float32, fused_ops=True)
    # optax.adamw(1e-3), as that test uses: no clipping, no schedule.
    tx = optim.make_optimizer(OptimConfig(
        learning_rate=1e-3, warmup_steps=0, schedule="constant",
        grad_clip_norm=None))
    return create_train_state(0, BertForSequenceClassification(cfg, "meta"),
                              tx, device=device)


@pytest.fixture
def one_thread():
    """Run torch's CPU ops on one thread: the tiny model's ops are too
    small to gain from more, and more threads contend with the other test
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fit_trains_a_tiny_bert(one_thread):
    state = _tiny_bert_state()
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), label_key="label")
    batches = synthetic.synthetic_token_batches(16, seq_len=32, vocab_size=256,
                                                num_batches=40)
    seen = []
    state, last, info = fit(step, state, batches, 1, log_every=1,
                            logger=lambda n, m: seen.append(m["loss"]))
    assert info["steps"] == 40 and state.step == 40 and len(seen) == 40
    assert last["loss"] == seen[-1]
    assert seen[-1] < 0.7 * seen[0], f"loss did not decrease: {seen}"


def test_fit_and_step_refuse_what_is_not_ported():
    state = _tiny_bert_state()
    step = make_classification_train_step(input_keys=("input_ids",))
    batches = synthetic.synthetic_token_batches(2, 8, 256, num_batches=4)
    state, _, info = fit(step, state, batches, 0, num_steps=2,
                         steps_per_dispatch=1, async_metrics=False)
    assert info["steps"] == 2
    # Checkpointing and preemption are ported (tests/test_torch_ft.py),
    # and so is the profiler window (tests/test_torch_run_obs.py).
    for kw, item in ((dict(steps_per_dispatch=8), "item 10"),
                     (dict(async_metrics=True), "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            fit(step, state, batches, 0, **kw)
    # Accumulation is ported (tests/test_torch_accumulation.py).
    make_classification_train_step(accum_steps=4)
    # The MoE aux loss is ported (tests/test_torch_moe.py).
    make_classification_train_step(moe_aux_weight=0.01)
    # Precision policies are ported (tests/test_torch_precision.py).
    assert make_classification_train_step(precision="bf16").precision.name \
        == "bf16"
    with pytest.raises(ValueError, match="unknown precision policy"):
        make_classification_train_step(precision="fp4")
    # The fused loss is ported.
    make_classification_train_step(loss_impl="auto")


# ---------------------------------------------------------------------------
# the fused slice: attention_impl="fused" and the fused loss
# ---------------------------------------------------------------------------

_SLICE_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
                  intermediate_size=64, hidden_dropout=0.0,
                  attention_dropout=0.0, max_position_embeddings=32)
_KEYS = ("input_ids", "attention_mask")


def _slice_batch(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, seq), np.int32)
    for b in range(batch):  # ragged right padding
        mask[b, rng.integers(seq // 2, seq + 1):] = 0
    return {
        "input_ids": rng.integers(0, 128, (batch, seq)).astype(np.int32),
        "attention_mask": mask,
        "label": rng.integers(0, 2, (batch,)).astype(np.int32),
    }


def _slice_states(**overrides):
    """tpudl's state (fused_ops="force", attention_impl="fused": every
    Pallas kernel in interpret mode) and the port's (fused_ops=True,
    attention_impl="fused": the kernels' plain versions on the CPU), f32,
    same weights, the sst2_bert_base optimizer at a constant rate.
    ``overrides`` change ``_SLICE_CFG``."""
    from tpudl.config import get_config as jget
    from tpudl.models import bert as jbert
    from tpudl.train import create_train_state as jcreate
    from tpudl.train.optim import make_optimizer as jopt
    from tpudl_torch.models import bert

    cfg = dict(_SLICE_CFG, **overrides)
    jmodel = jbert.BertForSequenceClassification(jbert.BertConfig(
        dtype=jnp.float32, fused_ops="force", attention_impl="fused", **cfg))
    jocfg = dataclasses.replace(jget("sst2_bert_base").optim,
                                schedule="constant", warmup_steps=0)
    jstate = jcreate(jax.random.key(0), jmodel, jnp.zeros((1, 16), jnp.int32),
                     jopt(jocfg))
    ocfg = dataclasses.replace(get_config("sst2_bert_base").optim,
                               schedule="constant", warmup_steps=0)
    model = bert.BertForSequenceClassification(bert.BertConfig(
        dtype=torch.float32, fused_ops=True, attention_impl="fused", **cfg),
        device="meta")
    state = create_train_state(
        0, model, optim.make_optimizer(ocfg),
        params=bert.params_from_tpudl(jstate.params, device="cpu"),
        device="cpu")
    return jmodel, jstate, state


def test_fused_slice_train_step_matches_tpudl(one_thread):
    """One step of the slice as a whole, dropout off: the port's
    fused_ops=True, attention_impl="fused", loss_impl="auto" against
    tpudl's fused_ops="force", attention_impl="fused", loss_impl="fused".
    The bands of tests/test_torch_bert.py's train step (from
    tests/test_fused_ops_integration.py:75-91): the loss rtol 1e-4 /
    atol 1e-5, the gradients and the parameters after the update rtol
    2e-3 / atol 2e-5."""
    _check_fused_slice_step(_slice_states(), _slice_batch())


def test_fused_slice_train_step_at_seq_384_matches_tpudl(one_thread):
    """The same step on BERT_TINY (hidden 128, 2 layers, 2 heads, MLP
    512, BERT's vocabulary and 512 positions) at S = 384, where
    attention_impl="fused" runs the whole-row attention
    (tpudl_torch.ops.fused_attention; tpudl's fused_attention in
    interpret mode), batch 2, same bands."""
    _check_fused_slice_step(
        _slice_states(vocab_size=30522, hidden_size=128,
                      intermediate_size=512, max_position_embeddings=512),
        _slice_batch(batch=2, seq=384, seed=5))


def _check_fused_slice_step(states, batch):
    from tpudl.train import cross_entropy_loss as jloss
    from tpudl.train import make_classification_train_step as jstep
    from tpudl_torch.models import bert
    from tpudl_torch.rng import fold_in

    jmodel, jstate, state = states

    def loss_fn(params):
        logits = jmodel.apply({"params": params},
                              jnp.asarray(batch["input_ids"]),
                              jnp.asarray(batch["attention_mask"]),
                              train=True)
        return jloss(logits, jnp.asarray(batch["label"]), impl="fused")

    jgrads = jax.jit(jax.grad(loss_fn))(jstate.params)
    jnew, jmetrics = jax.jit(jstep(input_keys=_KEYS, loss_impl="fused"))(
        jstate, batch, jax.random.key(1))

    step = make_classification_train_step(input_keys=_KEYS, loss_impl="auto")
    grads, _ = step.grads_and_metrics(state, batch, fold_in(1, 0, "cpu"))
    state, metrics = step(state, batch, 1)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-4, atol=1e-5)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    for name, w in bert.params_from_tpudl(jgrads, device="cpu").items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"grad {name}")
    got = state.model.state_dict()
    for name, w in bert.params_from_tpudl(jnew.params, device="cpu").items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"param {name} diverged")


@pytest.mark.parametrize("valid", [False, True])
def test_fused_slice_eval_step_matches_tpudl(one_thread, valid):
    """make_classification_eval_step with the fused loss: the mean loss
    and accuracy, and with a "_valid" column the masked means over the
    real rows (tpudl.train.loop:467-517)."""
    from tpudl.train import make_classification_eval_step as jeval
    from tpudl_torch.train import make_classification_eval_step

    jmodel, jstate, state = _slice_states()
    batch = _slice_batch(seed=3)
    if valid:
        batch["_valid"] = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
    want = jax.jit(jeval(input_keys=_KEYS, loss_impl="fused"))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_classification_eval_step(input_keys=_KEYS, loss_impl="auto")
    got = step(state, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4, atol=1e-5)
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert got["loss"].requires_grad is False


# ---------------------------------------------------------------------------
# the Llama LoRA slice: frozen base, adapters and the classifier train
# ---------------------------------------------------------------------------

_LORA_CFG = dict(num_labels=2, lora_rank=4, attention_impl="flash",
                 vocab_size=128, max_seq_len=128)


def _lora_batch():
    rng = np.random.default_rng(31)
    mask = np.ones((4, 32), np.int32)
    mask[1, 20:] = 0
    mask[3, 25:] = 0
    return {"input_ids": rng.integers(0, 128, (4, 32)).astype(np.int32),
            "attention_mask": mask,
            "label": rng.integers(0, 2, (4,)).astype(np.int32)}


@pytest.fixture(scope="module")
def tpudl_lora_step():
    """tpudl's tiny LoRA classifier (fused_ops="force" and
    attention_impl="flash": every Pallas kernel in interpret mode), its
    params with lora_b drawn non-zero (with the zero init every lora_a
    gradient is exactly 0), the gradients of one step's loss and the
    params after two steps of lora_optimizer(make_optimizer(...)) with
    the llama3_8b_lora optimizer at a constant 1e-2."""
    from tpudl.config import get_config as jget
    from tpudl.models import llama as jllama
    from tpudl.models.lora import lora_optimizer as jlora_optimizer
    from tpudl.models.lora import trainable_param_count as jcount
    from tpudl.train import cross_entropy_loss as jloss
    from tpudl.train import make_classification_train_step as jstep
    from tpudl.train.loop import TrainState as JTrainState
    from tpudl.train.optim import make_optimizer as jopt

    batch = _lora_batch()
    # The param tree does not depend on the kernel tier: init the
    # composite model (no interpret-mode kernels at init).
    init = jllama.LlamaForSequenceClassification(jllama.LLAMA_TINY(
        dtype=jnp.float32, **dict(_LORA_CFG, attention_impl="reference")))
    params = jax.tree.map(np.asarray, init.init(
        jax.random.key(0), jnp.asarray(batch["input_ids"]))["params"])
    rng = np.random.default_rng(32)

    def fill(node):
        for key, value in node.items():
            if isinstance(value, dict):
                fill(value)
            elif key == "lora_b":
                node[key] = (0.05 * rng.normal(size=value.shape)).astype(
                    np.float32)

    fill(params)
    jmodel = jllama.LlamaForSequenceClassification(jllama.LLAMA_TINY(
        dtype=jnp.float32, fused_ops="force", **_LORA_CFG))
    ocfg = dataclasses.replace(jget("llama3_8b_lora").optim, warmup_steps=0,
                               schedule="constant", learning_rate=1e-2)
    tx = jlora_optimizer(jopt(ocfg), params, ("classifier",))
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=jax.tree.map(jnp.asarray, params),
                                tx=tx)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(batch["input_ids"]),
                              jnp.asarray(batch["attention_mask"]),
                              train=True)
        return jloss(logits, jnp.asarray(batch["label"]))

    grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    step = jax.jit(jstep(input_keys=_KEYS))
    s1, m1 = step(jstate, batch, jax.random.key(1))
    s2, _ = step(s1, batch, jax.random.key(1))
    return {"params": params, "grads": jax.tree.map(np.asarray, grads),
            "loss": float(m1["loss"]), "accuracy": float(m1["accuracy"]),
            "after": jax.tree.map(np.asarray, s2.params),
            "count": jcount(params, ("classifier",)), "optim": ocfg}


def _torch_lora_state(tpudl_lora_step):
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import lora_optimizer

    model = llama.LlamaForSequenceClassification(
        llama.LLAMA_TINY(dtype=torch.float32, **_LORA_CFG), device="meta")
    ocfg = OptimConfig(**dataclasses.asdict(tpudl_lora_step["optim"]))
    tx = lora_optimizer(optim.make_optimizer(ocfg), model, ("classifier",))
    params = llama.params_from_tpudl(tpudl_lora_step["params"],
                                     dtype=torch.float32, device="cpu")
    return create_train_state(0, model, tx, params=params, device="cpu")


def test_llama_lora_train_step_matches_tpudl(tpudl_lora_step, one_thread):
    """The slice's step on the tiny model, the port's plain versions
    against tpudl's interpret-mode kernels: the loss rtol 1e-4 / atol
    1e-5, every adapter and classifier gradient and every parameter after
    two updates rtol 2e-3 / atol 2e-5 (the BERT step's bands), the frozen
    base bit-identical, and the trainable count tpudl's."""
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import trainable_param_count
    from tpudl_torch.rng import fold_in

    state = _torch_lora_state(tpudl_lora_step)
    batch = _lora_batch()
    step = make_classification_train_step(input_keys=_KEYS)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert trainable_param_count(before, ("classifier",)) == \
        tpudl_lora_step["count"]
    grads, metrics = step.grads_and_metrics(state, batch, fold_in(1, 0, "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), tpudl_lora_step["loss"],
                               rtol=1e-4, atol=1e-5)
    assert float(metrics["accuracy"]) == tpudl_lora_step["accuracy"]
    want = llama.params_from_tpudl(tpudl_lora_step["grads"],
                                   dtype=torch.float32, device="cpu")
    assert set(grads) == set(state.params)
    assert all(k.endswith(("lora_a", "lora_b")) or k.startswith("classifier")
               for k in grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"grad {name}")
    for _ in range(2):
        state, _ = step(state, batch, 1)
    after = llama.params_from_tpudl(tpudl_lora_step["after"],
                                    dtype=torch.float32, device="cpu")
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), after[name].numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"param {name}")
        if name not in grads:
            assert torch.equal(p, before[name]), f"frozen {name} changed"


def test_optimizer_state_covers_the_trainable_parameters_only(
        tpudl_lora_step):
    """No moments, and no zero gradients, for the frozen base; BERT's
    step trains every parameter as before."""
    state = _torch_lora_state(tpudl_lora_step)
    trainable = {n for n, p in state.model.named_parameters()
                 if p.requires_grad}
    assert set(state.params) == trainable
    assert set(state.opt_state["mu"]) == set(state.opt_state["nu"]) == trainable
    assert len(trainable) == 2 * 7 * 2 + 2
    bert = _tiny_bert_state()
    assert set(bert.params) == set(dict(bert.model.named_parameters()))


def test_llama3_8b_lora_config_matches_tpudl():
    from tpudl.config import get_config as jget

    want, got = jget("llama3_8b_lora"), get_config("llama3_8b_lora")
    assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
    for field in ("model", "dataset", "global_batch_size", "seq_len",
                  "num_classes", "num_steps", "seed", "accum_steps"):
        assert getattr(got, field) == getattr(want, field)
