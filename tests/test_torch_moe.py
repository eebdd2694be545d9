"""tpudl_torch.ops.moe against tpudl.ops.moe on the CPU.

The same numpy-seeded router probabilities, weights and inputs go
through both packages: the capacity, the top-k routing's dispatch and
combine tensors (exactly) and its aux loss, the MoE layer (f32, 1e-5),
the layer with identical experts against the dense MLP, the tiny MoE
Llama's train step with ``moe_aux_weight`` (loss, aux and every
gradient against tpudl's), and the weight bridge's MoE leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops import moe as jmoe
from tpudl_torch.ops import moe as tmoe

B, S, E, M, H = 2, 16, 4, 8, 16


def _probs(seed, shape=(B, S, E)):
    logits = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("args", [(128, 8, 2, 1.25), (4, 64, 1, 1.0),
                                  (2048, 8, 2, 1.25), (7, 3, 2, 0.5)])
def test_expert_capacity_matches_tpudl(args):
    assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 5), (2, 32), (3, 4)])
def test_route_topk_matches_tpudl(k, capacity):
    probs = _probs(k * 10 + capacity)
    jd, jc, ja = jmoe.route_topk(jnp.asarray(probs), k, capacity)
    td, tc, ta = tmoe.route_topk(torch.from_numpy(probs), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=1e-6)


def test_route_topk_contracts():
    """tpudl's routing contracts (tests/test_moe.py): every token lands k
    slots with ample capacity; a full expert drops tokens, whose combine
    weight is zero; a dropped choice's mass shrinks the survivor's
    weight; the aux loss is 1 at perfect balance; ties go to the first
    index."""
    probs = torch.from_numpy(_probs(0))
    disp, comb, _ = tmoe.route_topk(probs, 2, S * 2)
    assert float(disp.sum()) == B * S * 2
    torch.testing.assert_close(comb.sum((2, 3)), torch.ones(B, S))
    onto0 = torch.zeros(1, S, E)
    onto0[:, :, 0] = 1.0
    disp, comb, _ = tmoe.route_topk(onto0, 1, 3)
    assert float(disp.sum()) == 3.0
    per_token = comb.sum((2, 3))[0]
    assert torch.equal(per_token[:3], torch.ones(3))
    assert torch.equal(per_token[3:], torch.zeros(S - 3))
    two = torch.tensor([[[0.6, 0.3, 0.05, 0.05], [0.6, 0.05, 0.3, 0.05]]])
    _, comb, _ = tmoe.route_topk(two, 2, 1)
    per_token = comb.sum((2, 3))[0]
    assert abs(float(per_token[0]) - 1.0) < 1e-6
    assert abs(float(per_token[1]) - 0.3 / 0.9) < 1e-6
    _, _, aux = tmoe.route_topk(torch.full((B, S, E), 1.0 / E), 1, S)
    assert abs(float(aux) - 1.0) < 1e-5
    disp, _, _ = tmoe.route_topk(torch.full((1, 2, E), 1.0 / E), 1, 2)
    assert torch.equal(disp[0, :, 0].sum(-1), torch.ones(2))


def _layers(gated, k, capacity_factor=1.25, seed=1):
    """(tpudl MoEMlp, its params, port MoEMlp bound to the same weights,
    x) in f32."""
    jlayer = jmoe.MoEMlp(
        num_experts=E, intermediate_size=H, k=k,
        capacity_factor=capacity_factor, gated=gated,
        **({"act": jax.nn.silu} if gated else {}), dtype=jnp.float32)
    x = np.random.default_rng(seed).normal(size=(B, S, M)).astype(np.float32)
    params = jax.tree.map(np.asarray, jlayer.init(
        jax.random.key(seed), jnp.asarray(x))["params"])
    tlayer = tmoe.MoEMlp(M, E, H, k=k, capacity_factor=capacity_factor,
                         gated=gated, dtype=torch.float32, device="cpu")
    state = {"router.weight": torch.from_numpy(
        params["router"]["kernel"].T.copy()),
        "wi": torch.from_numpy(params["wi"].copy()),
        "wo": torch.from_numpy(params["wo"].copy())}
    if gated:
        state["wg"] = torch.from_numpy(params["wg"].copy())
    tlayer.load_state_dict(state, strict=True)
    return jlayer, params, tlayer, x


@pytest.mark.parametrize("gated,k,cf", [(False, 1, 1.25), (True, 2, 1.25),
                                         (False, 2, 0.5), (True, 2, 0.5)])
def test_moe_mlp_matches_tpudl(gated, k, cf):
    jlayer, params, tlayer, x = _layers(gated, k, cf)
    want, inter = jlayer.apply({"params": params}, jnp.asarray(x),
                               mutable=["intermediates"])
    got = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    jaux = float(inter["intermediates"]["moe_aux_loss"][0])
    assert abs(float(tlayer.aux_loss.detach()) - jaux) <= 1e-6
    recorded = tlayer.aux_loss
    assert tmoe.take_moe_aux_losses(tlayer) == [recorded]
    assert tlayer.aux_loss is None and tmoe.take_moe_aux_losses(tlayer) == []


@pytest.mark.parametrize("k", [1, 2])
def test_moe_identical_experts_match_dense(k):
    """Every expert the same dense FFN and ample capacity: the layer is
    that FFN (tpudl's contract, 1e-4)."""
    _, _, tlayer, x = _layers(False, k, capacity_factor=float(E))
    with torch.no_grad():
        tlayer.wi.copy_(tlayer.wi[:1].expand_as(tlayer.wi))
        tlayer.wo.copy_(tlayer.wo[:1].expand_as(tlayer.wo))
    xt = torch.from_numpy(x)
    want = torch.nn.functional.gelu(xt @ tlayer.wi[0], approximate="tanh") \
        @ tlayer.wo[0]
    torch.testing.assert_close(tlayer(xt).detach(), want, rtol=0, atol=1e-4)


def test_moe_rules_are_tpudl_data():
    assert [r for r, _ in tmoe.EP_MOE_RULES] == \
        [r for r, _ in jmoe.EP_MOE_RULES]
    assert [tuple(s) for _, s in tmoe.EP_MOE_RULES] == \
        [tuple(s) for _, s in jmoe.EP_MOE_RULES]
    assert tmoe.with_moe_rules((("x", None),))[-1] == ("x", None)


def _moe_batch():
    rng = np.random.default_rng(41)
    mask = np.ones((4, 24), np.int32)
    mask[2, 17:] = 0
    return {"input_ids": rng.integers(1, 512, (4, 24)).astype(np.int32),
            "attention_mask": mask,
            "label": rng.integers(0, 2, (4,)).astype(np.int32)}


def test_llama_tiny_moe_step_matches_tpudl(one_thread):
    """llama-tiny-moe (4 experts) trained with moe_aux_weight=0.01: the
    loss (which includes the aux term), the moe_aux metric and every
    gradient (router included) against tpudl's value_and_grad of the
    same objective (rtol 2e-3 / atol 2e-5, the BERT step's bands)."""
    from tpudl.models import llama as jllama
    from tpudl.train import cross_entropy_loss as jloss
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import llama as tllama
    from tpudl_torch.models.registry import build_model
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    weight = 0.01
    batch = _moe_batch()
    jmodel = jllama.LlamaForSequenceClassification(
        jllama.LLAMA_TINY(dtype=jnp.float32, moe_experts=4))
    ids, mask = jnp.asarray(batch["input_ids"]), jnp.asarray(
        batch["attention_mask"])
    jparams = jmodel.init(jax.random.key(0), ids)["params"]

    def loss_fn(p):
        logits, mut = jmodel.apply({"params": p}, ids, mask, train=True,
                                   mutable=["intermediates"])
        aux = sum(jnp.sum(leaf) for path, leaf
                  in jax.tree_util.tree_leaves_with_path(mut["intermediates"])
                  if "moe_aux_loss" in jax.tree_util.keystr(path))
        return jloss(logits, jnp.asarray(batch["label"])) + weight * aux, aux

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams)
    model = build_model("llama-tiny-moe", 2, device="meta",
                        dtype=torch.float32, moe_experts=4)
    assert model.cfg.moe_experts == 4 and model.cfg.moe_k == 2
    params = tllama.params_from_tpudl(jax.tree.map(np.asarray, jparams),
                                      dtype=torch.float32, device="cpu")
    state = create_train_state(0, model, make_optimizer(OptimConfig()),
                               params=params, device="cpu")
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), moe_aux_weight=weight)
    grads, metrics = step.grads_and_metrics(state, batch, fold_in(1, 0, "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(jaux),
                               rtol=1e-5, atol=1e-6)
    assert float(metrics["moe_aux"]) > 0
    want = tllama.params_from_tpudl(jax.tree.map(np.asarray, jgrads),
                                    dtype=torch.float32, device="cpu")
    assert set(grads) == set(want)
    assert float(grads["model.layer_0.moe.router.weight"].abs().max()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=f"grad {name}")
    state, m = step(state, batch, 1)
    assert "moe_aux" in m and np.isfinite(float(m["loss"]))


def test_bridge_maps_the_moe_leaves():
    from tpudl.models import llama as jllama
    from tpudl_torch.models import llama as tllama

    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(
        dtype=jnp.float32, moe_experts=4))
    jparams = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(2), jnp.zeros((1, 4), jnp.int32))["params"])
    params = tllama.params_from_tpudl(jparams, dtype=torch.bfloat16,
                                      device="cpu")
    assert set(params) == tllama.param_names(2, False, "lm_head", moe=True)
    moe = jparams["model"]["layer_1"]["moe"]
    np.testing.assert_array_equal(
        params["model.layer_1.moe.router.weight"].numpy(),
        moe["router"]["kernel"].T)
    assert params["model.layer_1.moe.router.weight"].dtype == torch.float32
    assert params["model.layer_1.moe.wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["model.layer_1.moe.wo"].float().numpy(),
        torch.from_numpy(moe["wo"].copy()).bfloat16().float().numpy())
    model = tllama.LlamaForCausalLM(tllama.LLAMA_TINY(moe_experts=4),
                                    device="meta")
    assert set(model.state_dict()) == set(params)
    del jparams["model"]["layer_0"]["moe"]["wg"]
    with pytest.raises(ValueError, match="lacks parameters"):
        tllama.params_from_tpudl(jparams, device="cpu")
