"""The rest of the port's train loop against tpudl's on the CPU: gradient
accumulation (``accum_steps``), BatchNorm statistics threaded through the
microbatches, ``microbatch``, ``pad_batch`` and ``evaluate`` over a
ragged dataset, and rematerialization.

The optimizer in the step comparisons is SGD (Nesterov, momentum 0.9) at
a constant rate without clipping or decay, so each parameter's update is
-1.9 x lr x its gradient and the updates compare the gradients. Bands:
the loss rtol 1e-4 / atol 1e-5, the updates rtol 2e-3 / atol 1e-6 and
the running statistics rtol 1e-4 / atol 1e-5 (f32; only the summation
order differs, as in tests/test_torch_train.py's step bands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl_torch.config import OptimConfig
from tpudl_torch.models import resnet
from tpudl_torch.rng import fold_in, fold_seed
from tpudl_torch.train import (
    create_train_state,
    cross_entropy_loss,
    evaluate,
    make_classification_eval_step,
    make_classification_train_step,
    make_optimizer,
    microbatch,
    pad_batch,
)

_SGD = dict(name="sgd", learning_rate=1.0, warmup_steps=0,
            schedule="constant", weight_decay=0.0, grad_clip_norm=None)
_BERT = dict(vocab_size=256, max_position_embeddings=64)
_KEYS = ("input_ids", "attention_mask")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _token_batch(rows, seed=0, seq=16):
    rng = np.random.default_rng(seed)
    mask = np.ones((rows, seq), np.int32)
    for b in range(rows):
        mask[b, rng.integers(seq // 2, seq + 1):] = 0
    return {"input_ids": rng.integers(0, 256, (rows, seq)).astype(np.int32),
            "attention_mask": mask,
            "label": rng.integers(0, 2, rows).astype(np.int32)}


def _image_batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(rows, 16, 16, 3)).astype(np.float32),
            "label": rng.integers(0, 4, rows).astype(np.int32)}


def _jax_sgd():
    from tpudl.config import OptimConfig as JOptimConfig
    from tpudl.train.optim import make_optimizer as jopt

    return jopt(JOptimConfig(**_SGD))


def _bert_states(dropout=0.0, **port_kw):
    """tpudl's BERT_TINY state and the port's from the same weights (f32,
    the composite path); ``port_kw`` go to the port's config."""
    from tpudl.models import bert as jbert
    from tpudl.train import create_train_state as jcreate
    from tpudl_torch.models import bert

    drop = dict(hidden_dropout=dropout, attention_dropout=dropout)
    jmodel = jbert.BertForSequenceClassification(jbert.BERT_TINY(
        dtype=jnp.float32, **_BERT, **drop))
    jstate = jcreate(jax.random.key(0), jmodel, jnp.zeros((1, 16), jnp.int32),
                     _jax_sgd())
    model = bert.BertForSequenceClassification(bert.BERT_TINY(
        dtype=torch.float32, **_BERT, **drop, **port_kw), device="meta")
    state = create_train_state(
        0, model, make_optimizer(OptimConfig(**_SGD)),
        params=bert.params_from_tpudl(jstate.params, device="cpu"),
        device="cpu")
    return jstate, state


def _resnet_states():
    from tpudl.models.resnet import ResNetTiny
    from tpudl.train import TrainState as JTrainState

    jmodel = ResNetTiny(num_classes=4, dtype=jnp.float32)
    v = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False))(
        jnp.zeros((1, 16, 16, 3)))
    # Nonzero last-BatchNorm scales, so every gradient is nonzero.
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 if p[-1].key == "scale" else a, v["params"])
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=params,
                                batch_stats=v["batch_stats"], tx=_jax_sgd())
    state = create_train_state(
        0, resnet.ResNetTiny(num_classes=4, dtype=torch.float32,
                             device="meta"),
        make_optimizer(OptimConfig(**_SGD)),
        params=resnet.params_from_tpudl(params, v["batch_stats"], "cpu"),
        device="cpu")
    return jstate, state


def _check_step(jstate, state, batch, accum, input_keys, bridge,
                has_stats=False):
    from tpudl.train import make_classification_train_step as jstep

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    jnew, jm = jax.jit(jstep(input_keys=input_keys, accum_steps=accum))(
        jstate, batch, jax.random.key(1))
    step = make_classification_train_step(input_keys=input_keys,
                                          accum_steps=accum)
    state, m = step(state, batch, 1)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want = (bridge(jnew.params, jnew.batch_stats, device="cpu") if has_stats
            else bridge(jnew.params, device="cpu"))
    after = state.model.state_dict()
    assert set(want) == set(after)
    moved = 0
    for k, v in want.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(after[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose((after[k] - before[k]).numpy(),
                                       (v - before[k]).numpy(), rtol=2e-3,
                                       atol=1e-6, err_msg=k)
        moved += not torch.equal(after[k], before[k])
    assert moved > len(want) // 2


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_bert_step_matches_tpudl(one_thread, accum):
    from tpudl_torch.models.bert import params_from_tpudl

    jstate, state = _bert_states()
    _check_step(jstate, state, _token_batch(16), accum, _KEYS,
                params_from_tpudl)


def test_accumulated_resnet_step_matches_tpudl(one_thread):
    """ResNetTiny at accum 2: the loss, the updates and the running
    statistics after both microbatches moved them in order."""
    jstate, state = _resnet_states()
    _check_step(jstate, state, _image_batch(16), 2, ("image",),
                resnet.params_from_tpudl, has_stats=True)
    assert state.batch_stats is not None and len(state.batch_stats) == 12


def test_step_at_one_microbatch_is_the_plain_step_bitwise(one_thread):
    """At accum 1 the step is a forward and backward of the whole batch
    with ``fold_in(rng, step)``'s dropout, and the update of those
    gradients, bit for bit; at accum 2 it sums the microbatches' plain
    gradients, drawn from ``fold_in(fold_seed(rng, step), a)``, then
    halves them."""
    from tpudl_torch.models import bert

    cfg = bert.BERT_TINY(dtype=torch.float32, **_BERT)  # dropout 0.1
    batch = _token_batch(8, seed=3)

    def state():
        return create_train_state(0, bert.BertForSequenceClassification(
            cfg, device="meta"), make_optimizer(OptimConfig(**_SGD)),
            device="cpu")

    def plain_grads(st, rows, gen):
        t = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        logits = st.model(t["input_ids"], t["attention_mask"], train=True,
                          generator=gen)
        loss = cross_entropy_loss(logits, t["label"].long())
        grads = torch.autograd.grad(loss, list(st.params.values()))
        return dict(zip(st.params, grads)), loss.detach()

    ref = state()
    want, loss = plain_grads(ref, slice(None), fold_in(5, 0, "cpu"))
    ref.apply_gradients(want)
    st = state()
    step = make_classification_train_step(input_keys=_KEYS)
    st, m = step(st, batch, 5)
    assert torch.equal(m["loss"], loss)
    for k, p in st.model.state_dict().items():
        assert torch.equal(p, ref.model.state_dict()[k]), k

    seed = fold_seed(5, 0)
    parts = [plain_grads(state(), slice(4 * a, 4 * a + 4),
                         fold_in(seed, a, "cpu")) for a in range(2)]
    acc = make_classification_train_step(input_keys=_KEYS, accum_steps=2)
    grads, m = acc.grads_and_metrics(
        state(), batch, [fold_in(seed, a, "cpu") for a in range(2)])
    for k, g in grads.items():
        assert torch.equal(g, (parts[0][0][k] + parts[1][0][k]) / 2), k
    assert torch.equal(m["loss"], (parts[0][1] + parts[1][1]) / 2)
    with pytest.raises(ValueError, match="one generator per microbatch"):
        acc.grads_and_metrics(state(), batch, fold_in(seed, 0, "cpu"))


def test_microbatch_covers_each_row_once():
    for x in (np.arange(24).reshape(12, 2), torch.arange(24).reshape(12, 2)):
        split = microbatch({"x": x, "y": x[:, 0]}, 3)
        assert tuple(split["x"].shape) == (3, 4, 2)
        rows = np.asarray(split["y"]).ravel().tolist()
        assert sorted(rows) == list(range(0, 24, 2))
        assert np.asarray(split["y"])[1].tolist() == [8, 10, 12, 14]


def test_indivisible_batch_raises():
    with pytest.raises(ValueError, match="not divisible by accum_steps 5"):
        microbatch({"x": np.zeros((12, 2))}, 5)
    step = make_classification_train_step(accum_steps=5)
    _, state = _resnet_states()
    with pytest.raises(ValueError, match="not divisible"):
        step(state, _image_batch(12), 0)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        make_classification_train_step(accum_steps=0)


def test_pad_batch_and_evaluate_match_tpudl(one_thread):
    """A ragged dataset (8, 8, 5 rows) through ResNetTiny's eval step (the
    running statistics): tpudl's evaluate and the port's, the tail padded
    to 8 with a "_valid" mask, against the unpadded per-example mean; a
    step without the marker runs the tail at its own size."""
    from tpudl.train import evaluate as jevaluate
    from tpudl.train import make_classification_eval_step as jeval
    from tpudl.train import pad_batch as jpad

    jstate, state = _resnet_states()
    data = [_image_batch(n, seed=10 + i) for i, n in enumerate((8, 8, 5))]
    padded = pad_batch(data[2], 8)
    jpadded = jpad(data[2], 8)
    assert set(padded) == set(jpadded) == {"image", "label", "_valid"}
    for k in padded:
        np.testing.assert_array_equal(np.asarray(padded[k]),
                                      np.asarray(jpadded[k]))
    again = pad_batch(padded, 10)
    assert again["_valid"].tolist() == [1.0] * 5 + [0.0] * 5
    t = pad_batch({k: torch.as_tensor(v) for k, v in data[2].items()}, 8)
    assert torch.equal(t["image"], torch.as_tensor(padded["image"]))
    with pytest.raises(ValueError, match="cannot pad"):
        pad_batch(data[0], 4)

    want = jevaluate(jax.jit(jeval()), jstate, data)
    step = make_classification_eval_step()
    assert step.mask_aware
    sizes = []

    def recorded(st, batch):
        sizes.append(len(batch["label"]))
        return step(st, batch)

    recorded.mask_aware = True
    got = evaluate(recorded, state, data)
    assert sizes == [8, 8, 8]
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)
    # The example-weighted mean is the mean over the 21 rows.
    whole = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    ref = step(state, whole)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-5)
    sizes.clear()
    recorded.mask_aware = False
    unpadded = evaluate(recorded, state, data)
    assert sizes == [8, 8, 5]
    np.testing.assert_allclose(unpadded["loss"], got["loss"], rtol=1e-5)
    assert evaluate(step, state, data, num_steps=1) == pytest.approx(
        {k: float(v) for k, v in step(state, data[0]).items()})
    with pytest.raises(ValueError, match="no batches"):
        evaluate(step, state, [])


@pytest.mark.parametrize("remat,policy,attention", [
    ("layer", None, "reference"), ("attention", None, "reference"),
    ("layer", "dots_saveable", "reference"), ("layer", None, "fused")])
def test_bert_remat_gradients_are_bitwise_without_remat(one_thread, remat,
                                                        policy, attention):
    """BERT_TINY with dropout 0.1 (the fused attention draws its seed
    words from the generator too): the loss and every gradient of a
    rematerialized step equal the step's without remat, bit for bit; a
    recompute that drew new bits would not."""
    from tpudl_torch.models import bert

    batch = _token_batch(4, seed=2)
    out = {}
    for r, p in ((False, None), (remat, policy)):
        cfg = bert.BERT_TINY(dtype=torch.float32, remat=r, remat_policy=p,
                             attention_impl=attention, fused_ops=True, **_BERT)
        st = create_train_state(0, bert.BertForSequenceClassification(
            cfg, device="meta"), make_optimizer(OptimConfig(**_SGD)),
            device="cpu")
        step = make_classification_train_step(input_keys=_KEYS)
        out[r] = step.grads_and_metrics(st, batch, fold_in(3, 0, "cpu"))
    (g0, m0), (g1, m1) = out[False], out[remat]
    assert torch.equal(m0["loss"], m1["loss"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    other = step.grads_and_metrics(st, batch, fold_in(4, 0, "cpu"))[0]
    assert not all(torch.equal(g0[k], other[k]) for k in g0)


def test_llama_lora_remat_gradients_are_bitwise_without_remat(one_thread):
    """LLAMA_TINY with rank-4 adapters on a frozen base (the blocks'
    inputs need no gradient) and padded rows: remat gives every adapter
    and classifier gradient bitwise, and nonzero."""
    from tpudl_torch.models import llama
    from tpudl_torch.models.lora import lora_optimizer

    rng = np.random.default_rng(1)
    mask = np.ones((4, 24), np.int32)
    mask[1, 15:] = 0
    batch = {"input_ids": rng.integers(0, 512, (4, 24)), "attention_mask": mask,
             "label": rng.integers(0, 2, 4)}
    out = {}
    for remat in (False, True):
        cfg = llama.LLAMA_TINY(dtype=torch.float32, lora_rank=4, remat=remat)
        model = llama.LlamaForSequenceClassification(cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("lora_b"):
                    p.normal_(0.0, 0.05, generator=torch.Generator()
                              .manual_seed(hash(name) % 1000))
        st = create_train_state(0, model, lora_optimizer(
            make_optimizer(OptimConfig(**_SGD)), model, ("classifier",)),
            params={k: v.detach().clone()
                    for k, v in model.state_dict().items()}, device="cpu")
        step = make_classification_train_step(input_keys=_KEYS)
        out[remat] = step.grads_and_metrics(st, batch, fold_in(3, 0, "cpu"))
    (g0, m0), (g1, m1) = out[False], out[True]
    assert len(g0) == 2 * 7 * 2 + 2
    assert torch.equal(m0["loss"], m1["loss"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
        assert g0[k].abs().max() > 0, k
