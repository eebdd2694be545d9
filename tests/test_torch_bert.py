"""tpudl_torch.models.bert and its train step against tpudl on the CPU.

The weights are tpudl's (``model.init``), carried over by
``params_from_tpudl``; inputs come from numpy with a seed. The port's
``fused_ops=True`` on CPU tensors runs the plain versions of its kernels;
tpudl's ``fused_ops="force"`` runs its Pallas kernels in interpret mode.
Bands are tpudl's own: f32 forward 1e-5; the train step's loss rtol
1e-4 / atol 1e-5 and the parameters after it rtol 2e-3 / atol 2e-5
(tests/test_fused_ops_integration.py:75-91).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import bert as jbert
from tpudl_torch.models import bert
from tpudl_torch.models.registry import build_model

_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, hidden_dropout=0.0, attention_dropout=0.0,
            max_position_embeddings=32)


def _jax_model(fused_ops):
    return jbert.BertForSequenceClassification(
        jbert.BertConfig(dtype=jnp.float32, fused_ops=fused_ops, **_CFG))


def _port_model(fused_ops):
    return bert.BertForSequenceClassification(
        bert.BertConfig(dtype=torch.float32, fused_ops=fused_ops, **_CFG),
        device="cpu")


def _tpudl_params(seed=0):
    ids = jnp.zeros((1, 16), jnp.int32)
    return _jax_model(False).init(jax.random.key(seed), ids)["params"]


def _batch(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, seq), np.int32)
    for b in range(batch):  # ragged right padding
        mask[b, rng.integers(seq // 2, seq + 1):] = 0
    return {
        "input_ids": rng.integers(0, 128, (batch, seq)).astype(np.int32),
        "attention_mask": mask,
        "label": rng.integers(0, 2, (batch,)).astype(np.int32),
    }


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def test_bridge_layout():
    tree = _tpudl_params()
    params = bert.params_from_tpudl(tree, device="cpu")
    assert set(params) == bert.param_names(2)
    assert set(params) == set(_port_model(False).state_dict())
    flat = _flat(tree)
    q = flat["bert/encoder/layer_1/attention/query/kernel"]
    np.testing.assert_array_equal(
        params["bert.encoder.layer_1.attention.query.weight"].numpy(), q.T)
    np.testing.assert_array_equal(
        params["bert.embeddings.word_embeddings.weight"].numpy(),
        flat["bert/embeddings/word_embeddings/embedding"])
    np.testing.assert_array_equal(
        params["bert.encoder.layer_0.output_norm.scale"].numpy(),
        flat["bert/encoder/layer_0/output_norm/scale"])
    np.testing.assert_array_equal(params["classifier.weight"].numpy(),
                                  flat["classifier/kernel"].T)
    assert all(t.dtype == torch.float32 for t in params.values())


def test_bridge_covers_the_fused_attention_tree():
    """attention_impl does not change the parameter tree: a tpudl model
    built with attention_impl="fused" has the reference model's leaves,
    and params_from_tpudl loads it into the port's fused-attention model,
    whose logits then match tpudl's (interpreted kernels) at 1e-5."""
    fused_cfg = dict(_CFG, attention_impl="fused")
    jmodel = jbert.BertForSequenceClassification(
        jbert.BertConfig(dtype=jnp.float32, fused_ops="force", **fused_cfg))
    ids = jnp.zeros((1, 16), jnp.int32)
    tree = jmodel.init(jax.random.key(1), ids)["params"]
    assert (jax.tree.structure(tree)
            == jax.tree.structure(_tpudl_params(1)))
    params = bert.params_from_tpudl(tree, device="cpu")
    assert set(params) == bert.param_names(2)
    model = bert.BertForSequenceClassification(
        bert.BertConfig(dtype=torch.float32, fused_ops=True, **fused_cfg),
        device="cpu")
    model.load_state_dict(params, strict=True)
    batch = _batch(seed=4)
    want = jmodel.apply({"params": tree}, jnp.asarray(batch["input_ids"]),
                        jnp.asarray(batch["attention_mask"]))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]),
                    torch.from_numpy(batch["attention_mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bridge_refusals():
    tree = _tpudl_params()
    extra = jax.tree.map(lambda x: x, tree)
    extra["bert"]["encoder"]["layer_0"]["attention"]["lora_a"] = {
        "kernel": np.zeros((32, 4), np.float32)}
    with pytest.raises(ValueError, match="no counterpart"):
        bert.params_from_tpudl(extra, device="cpu")
    odd = jax.tree.map(lambda x: x, tree)
    odd["bert"]["pooler"]["gamma"] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match="no counterpart"):
        bert.params_from_tpudl(odd, device="cpu")
    missing = jax.tree.map(lambda x: x, tree)
    del missing["bert"]["encoder"]["layer_1"]["output_norm"]
    with pytest.raises(ValueError, match="lacks parameters"):
        bert.params_from_tpudl(missing, device="cpu")
    quant = jax.tree.map(lambda x: x, tree)
    quant["bert"]["encoder"]["layer_0"]["intermediate"]["kernel"] = (
        np.zeros((32, 64), np.int8), np.ones(64, np.float32))
    with pytest.raises(ValueError, match="quantized"):
        bert.params_from_tpudl(quant, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_logits_match_tpudl_with_padding(fused):
    """Logits of the tpudl parity config with a padded mask: the port's
    composite (False) and fused tier (True, the kernels' plain versions
    here) against tpudl's composite and its interpreted Pallas kernels
    ("force")."""
    tree = _tpudl_params()
    batch = _batch()
    want = _jax_model("force" if fused else False).apply(
        {"params": tree}, jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["attention_mask"]))
    model = _port_model(fused)
    model.load_state_dict(bert.params_from_tpudl(tree, device="cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]),
                    torch.from_numpy(batch["attention_mask"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_tpudl(fused):
    """One make_classification_train_step step, dropout off, with the
    sst2_bert_base optimizer at a constant learning rate (as bench.py's
    _bench_bert runs it): the loss, then every parameter after the
    update."""
    from tpudl.config import get_config as jget
    from tpudl.train import create_train_state as jcreate
    from tpudl.train import make_classification_train_step as jstep
    from tpudl.train.optim import make_optimizer as jopt
    from tpudl_torch.config import get_config
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    batch = _batch()
    keys = ("input_ids", "attention_mask")
    jocfg = dataclasses.replace(jget("sst2_bert_base").optim,
                                schedule="constant", warmup_steps=0)
    jstate = jcreate(jax.random.key(0), _jax_model("force" if fused else False),
                     jnp.zeros((1, 16), jnp.int32), jopt(jocfg))
    jnew, jmetrics = jax.jit(jstep(input_keys=keys))(jstate, batch,
                                                     jax.random.key(1))

    ocfg = dataclasses.replace(get_config("sst2_bert_base").optim,
                               schedule="constant", warmup_steps=0)
    state = create_train_state(
        0, _port_model(fused), make_optimizer(ocfg),
        params=bert.params_from_tpudl(jstate.params, device="cpu"),
        device="cpu")
    step = make_classification_train_step(input_keys=keys)
    state, metrics = step(state, batch, 1)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-4, atol=1e-5)
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    want = bert.params_from_tpudl(jnew.params, device="cpu")
    got = state.model.state_dict()
    assert state.step == 1
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"param {name} diverged")


def test_dropout_draws_the_same_masks_on_both_tiers():
    """With dropout on, a forward with the fused tier and one with the
    composite tier draw the same masks from generators seeded alike, so
    they agree as closely as with dropout off."""
    tree = _tpudl_params()
    batch = _batch()
    outs = []
    for fused in (False, True):
        cfg = bert.BertConfig(dtype=torch.float32, fused_ops=fused,
                              **{**_CFG, "hidden_dropout": 0.1,
                                 "attention_dropout": 0.1})
        model = bert.BertForSequenceClassification(cfg, device="cpu")
        model.load_state_dict(bert.params_from_tpudl(tree, device="cpu"))
        with torch.no_grad():
            outs.append(model(torch.from_numpy(batch["input_ids"]),
                              torch.from_numpy(batch["attention_mask"]),
                              train=True,
                              generator=torch.Generator().manual_seed(3)))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dropout"):
        model(torch.from_numpy(batch["input_ids"]), train=True)


def test_registry_and_refusals():
    model = build_model("bert-tiny", 3, device="cpu", vocab_size=64)
    assert model.cfg.dtype == torch.bfloat16 and model.cfg.num_labels == 3
    assert model.cfg.hidden_size == 128 and model.cfg.num_layers == 2
    assert build_model("bert-base", 2, device="meta").cfg.hidden_size == 768
    assert build_model("bert-large", 2, device="meta").cfg.num_layers == 24
    # The CV path and remat are ported (tests/test_torch_resnet.py,
    # tests/test_torch_accumulation.py).
    assert build_model("resnet50", 2, device="meta").head.out_features == 2
    for remat in ("layer", "attention", True, "none"):
        build_model("bert-tiny", 2, device="meta", remat=remat)
    build_model("bert-tiny", 2, device="meta", remat="layer",
                remat_policy="dots_saveable")
    with pytest.raises(ValueError, match="remat must be one of"):
        build_model("bert-tiny", 2, device="meta", remat="blocks")
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        build_model("bert-tiny", 2, device="meta", remat="layer",
                    remat_policy="everything_saveable")
    # The MoE MLP is ported (tests/test_torch_moe.py).
    assert build_model("llama-tiny-lora-moe", 2,
                       device="meta").cfg.moe_experts == 8
    with pytest.raises(ValueError, match="unknown model"):
        build_model("gpt2", 2)
    # Quantized weights are ported (tests/test_torch_quant.py).
    assert build_model("bert-tiny", 2, device="meta",
                       weight_dtype="int8").cfg.weight_dtype == "int8"
    with pytest.raises(ValueError, match="weight_dtype must be one of"):
        build_model("bert-tiny", 2, device="meta", weight_dtype="int4")
    # fp8 training is ported (tests/test_torch_precision.py); it excludes
    # the quantized weight tier, as tpudl's.
    build_model("bert-tiny", 2, device="meta", fp8_train=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        build_model("bert-tiny", 2, device="meta", fp8_train=True,
                    weight_dtype="int8")
    # "flash" is ported (tests/test_torch_flash_attention.py); the
    # sequence-parallel implementations are not.
    m = _port_model(False)
    m.cfg = dataclasses.replace(m.cfg, attention_impl="ring")
    for layer in (m.bert.encoder.layer_0, m.bert.encoder.layer_1):
        layer.attention.cfg = m.cfg
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        m(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_logits_match_tpudl(fused):
    """The same comparison in bf16, the path's dtype: f32 masters cast at
    use, the f32 embedding sum (flax nn.Embed without a dtype returns its
    f32 table) and the f32 classifier put the two within bf16 rounding
    (tpudl's bf16 band 0.05)."""
    import flax.linen as fnn

    ids = jnp.zeros((1, 3), jnp.int32)
    embed = fnn.Embed(4, 2)
    assert embed.apply(embed.init(jax.random.key(0), ids), ids).dtype == jnp.float32
    tree = _tpudl_params()
    batch = _batch()
    want = jbert.BertForSequenceClassification(jbert.BertConfig(
        dtype=jnp.bfloat16, fused_ops="force" if fused else False, **_CFG)
    ).apply({"params": tree}, jnp.asarray(batch["input_ids"]),
            jnp.asarray(batch["attention_mask"]))
    model = bert.BertForSequenceClassification(
        bert.BertConfig(dtype=torch.bfloat16, fused_ops=fused, **_CFG),
        device="cpu")
    model.load_state_dict(bert.params_from_tpudl(tree, device="cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(batch["input_ids"]),
                    torch.from_numpy(batch["attention_mask"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.05,
                               atol=0.05)
