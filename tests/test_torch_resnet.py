"""The port's ResNet against tpudl's on the CPU, in f32: the forward in
train and eval mode through ``params_from_tpudl`` (the CIFAR stem of
ResNetTiny and ResNet-18, and ResNet-50's ImageNet stem at 64 and 65
pixels, where XLA's SAME padding is asymmetric at even sizes and
symmetric at odd ones), the running statistics after a train forward,
one train step's loss, gradients, parameters and statistics, the
analytic FLOP count, the weight bridge's refusals and the registry.

Tolerances: rtol 1e-4 / atol 1e-5 on the forward and the statistics (f32,
only the summation order differs); the step's bands are the BERT step's
(tests/test_torch_train.py): gradients and parameters rtol 2e-3 / atol
2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import resnet as jresnet
from tpudl_torch.models import resnet
from tpudl_torch.models.registry import build_model


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_variables(jmodel, x, seed=0):
    """A tpudl variables tree (the structure of ``jmodel.init``, traced
    only: drawing ResNet-50's weights with tpudl's PRNG takes seconds on
    the CPU) filled from numpy at tpudl's init scales, every BatchNorm
    leaf moved off its init value so that each leaf's place in the bridge
    shows in the output: scales 1 +- 0.1, the zero-init last scale of
    each block 0 +- 0.1 (as at init, the residual stream stays near unit
    scale: flax's E[x^2] - E[x]^2 batch variance and torch's Welford
    variance part by more than f32 rounding only where |mean| >> std),
    biases and means +- 0.1, variances |1 +- 0.1|."""
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.key(0), x, train=False), x)
    rng = np.random.default_rng(seed)
    last_norm = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(shapes["params"]):
        if path[-2].key.startswith("BatchNorm_"):
            block = path[-3].key
            last_norm[block] = max(last_norm.get(block, ""), path[-2].key)

    def fill(path, leaf):
        keys = [p.key for p in path]
        noise = 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        if keys[-1] == "kernel":
            return 10 * noise * np.float32(
                (2.0 / np.prod(leaf.shape[:-1])) ** 0.5)
        if keys[-1] == "scale" and last_norm.get(keys[-3]) != keys[-2]:
            return 1.0 + noise
        if keys[-1] == "var":
            return np.abs(1.0 + noise)
        return noise

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port(cls, variables, **kw):
    model = cls(dtype=torch.float32, device="meta", **kw)
    model.to_empty(device="cpu")
    model.load_state_dict(resnet.params_from_tpudl(
        variables["params"], variables["batch_stats"], device="cpu"),
        strict=True)
    return model


def _stats_of(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _check_forward(jcls, tcls, shape, kw):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jmodel = jcls(num_classes=5, dtype=jnp.float32, **kw)
    variables = _jax_variables(jmodel, x)
    model = _port(tcls, variables, num_classes=5, **kw)
    want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x)
    got = model(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32 and got.shape == (shape[0], 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    got = model(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    stats = _stats_of(model)
    flat = jax.tree_util.tree_leaves_with_path(mutated["batch_stats"])
    assert len(flat) == len(stats)
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        np.testing.assert_allclose(stats[key].numpy(), np.asarray(leaf),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name,shape", [("tiny", (3, 16, 16, 3)),
                                        ("resnet18", (2, 32, 32, 3))])
def test_cifar_stem_forward_and_statistics_match_tpudl(one_thread, name,
                                                       shape):
    if name == "tiny":
        _check_forward(jresnet.ResNetTiny, resnet.ResNetTiny, shape, {})
    else:
        _check_forward(jresnet.ResNet18, resnet.ResNet18, shape,
                       {"small_inputs": True})


@pytest.mark.parametrize("size", [64, 65])
def test_resnet50_forward_and_statistics_match_tpudl(one_thread, size):
    _check_forward(jresnet.ResNet50, resnet.ResNet50, (2, size, size, 3), {})


@pytest.mark.parametrize("n,k,s,want", [(224, 7, 2, (2, 3)), (65, 7, 2, (3, 3)),
                                        (112, 3, 2, (0, 1)), (57, 3, 2, (1, 1)),
                                        (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1))])
def test_same_pads_are_xla_s(n, k, s, want):
    assert resnet.same_pads(n, k, s) == want


def test_train_step_matches_tpudl(one_thread):
    """One step of ResNetTiny with the imagenet_resnet50_dp optimizer (SGD,
    Nesterov, decoupled decay, clipping) at a constant learning rate and
    label smoothing 0.1: the loss, every gradient, the parameters after
    the update and the running statistics."""
    from tpudl.config import OptimConfig as JOptimConfig
    from tpudl.train import TrainState as JTrainState
    from tpudl.train import cross_entropy_loss as jloss
    from tpudl.train import make_classification_train_step as jstep
    from tpudl.train import optim as joptim
    from tpudl_torch.config import OptimConfig, get_config
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    ocfg = dataclasses.replace(get_config("imagenet_resnet50_dp").optim,
                               schedule="constant", warmup_steps=0,
                               learning_rate=0.1)
    rng = np.random.default_rng(2)
    batch = {"image": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 4, size=8).astype(np.int32)}
    jmodel = jresnet.ResNetTiny(num_classes=4, dtype=jnp.float32)
    variables = _jax_variables(jmodel, batch["image"])
    jstate = JTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=joptim.make_optimizer(JOptimConfig(**dataclasses.asdict(ocfg))))

    def loss_fn(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch["image"], train=True, mutable=["batch_stats"])
        return jloss(logits, batch["label"], 0.1)

    jloss_value, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    jnew, jmetrics = jax.jit(jstep(0.1))(jstate, batch, jax.random.key(1))

    model = resnet.ResNetTiny(num_classes=4, dtype=torch.float32,
                              device="meta")
    state = create_train_state(0, model, make_optimizer(OptimConfig(
        **dataclasses.asdict(ocfg))), params=resnet.params_from_tpudl(
            variables["params"], variables["batch_stats"], device="cpu"),
        device="cpu")
    step = make_classification_train_step(0.1)
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    grads, metrics = step.grads_and_metrics(state, batch, fold_in(1, 0, "cpu"))
    # grads_and_metrics ran a train forward: put the statistics back.
    for k, v in stats0.items():
        state.batch_stats[k].copy_(v)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss_value),
                               rtol=1e-4, atol=1e-5)
    flat = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(flat) == len(grads)
    for path, leaf in flat:
        key = ".".join(p.key for p in path)
        key = key.replace(".kernel", ".weight")
        want = np.asarray(leaf)
        want = want.T if want.ndim == 2 else want
        want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
        np.testing.assert_allclose(grads[key].numpy(), want, rtol=2e-3,
                                   atol=2e-5, err_msg=key)
    state, m = step(state, batch, 1)
    np.testing.assert_allclose(float(m["loss"]), float(jmetrics["loss"]),
                               rtol=1e-4, atol=1e-5)
    got = resnet.params_from_tpudl(jnew.params, jnew.batch_stats, device="cpu")
    sd = state.model.state_dict()
    assert set(got) == set(sd)
    for k, v in got.items():
        tol = (1e-4, 1e-5) if k.endswith((".mean", ".var")) else (2e-3, 2e-5)
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=tol[0],
                                   atol=tol[1], err_msg=k)
    assert not all(torch.equal(stats0[k], state.batch_stats[k]) for k in stats0)


@pytest.mark.parametrize("name,size,kw", [
    ("resnet50", 64, {}), ("resnet18", 32, {"small_inputs": True}),
    ("resnet18", 65, {})])
def test_forward_flops_match_the_flop_counter(one_thread, name, size, kw):
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(name, 10, device="cpu", dtype=torch.float32, **kw)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.zeros(2, size, size, 3), train=False)
    assert counter.get_total_flops() == 2 * model.forward_flops(size, size)


def test_resnet50_at_224_counts_its_published_flops():
    """4.1 G multiply-adds an image at 224 x 224 (torchvision's figure),
    so 3 x forward x 1024 is ~2.5e13 FLOP a configs[2] step."""
    model = build_model("resnet50", 1000, device="meta")
    flops = model.forward_flops(224, 224)
    assert 8.1e9 < flops < 8.3e9
    assert 2.4e13 < 3 * flops * 1024 < 2.6e13


def test_bridge_raises_on_an_extra_or_missing_leaf():
    jmodel = jresnet.ResNetTiny(num_classes=4)
    v = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False))
    out = resnet.params_from_tpudl(v["params"], v["batch_stats"], device="cpu")
    assert set(out) == set(resnet.ResNetTiny(num_classes=4,
                                             device="meta").state_dict())

    def tree():
        return jax.tree.map(np.copy, v)

    extra = tree()
    extra["params"]["head"]["scale"] = np.ones(4, np.float32)
    with pytest.raises(ValueError, match="no counterpart"):
        resnet.params_from_tpudl(extra["params"], extra["batch_stats"], "cpu")
    extra = tree()
    extra["batch_stats"]["ResNetBlock_0"]["Conv_0"] = {"mean": np.zeros(8)}
    with pytest.raises(ValueError, match="no counterpart"):
        resnet.params_from_tpudl(extra["params"], extra["batch_stats"], "cpu")
    missing = tree()
    del missing["batch_stats"]["bn_init"]["var"]
    with pytest.raises(ValueError, match=r"lack leaves.*bn_init\.var"):
        resnet.params_from_tpudl(missing["params"], missing["batch_stats"],
                                 "cpu")
    missing = tree()
    del missing["params"]["ResNetBlock_1"]["norm_proj"]
    del missing["batch_stats"]["ResNetBlock_1"]["norm_proj"]
    with pytest.raises(ValueError, match="conv_proj without norm_proj"):
        resnet.params_from_tpudl(missing["params"], missing["batch_stats"],
                                 "cpu")
    missing = tree()
    del missing["params"]["head"]
    with pytest.raises(ValueError, match="head"):
        resnet.params_from_tpudl(missing["params"], missing["batch_stats"],
                                 "cpu")


def test_registry_configs_and_init_match_tpudl():
    from tpudl.config import get_config as jget
    from tpudl_torch.config import get_config

    for name, want in (("resnet18", 11_181_642), ("resnet34", 21_289_802),
                       ("resnet50", 23_528_522), ("resnet101", 42_520_650)):
        model = build_model(name, 10, device="meta")
        assert sum(p.numel() for p in model.parameters()) == want, name
        assert model.dtype == torch.bfloat16
    assert build_model("resnet18", 10, device="meta",
                       small_inputs=True).conv_init.kernel == 3
    with pytest.raises(ValueError, match="unknown resnet size"):
        build_model("resnet152", 10, device="meta")
    for name in ("cifar10_resnet18", "imagenet_resnet50_dp"):
        got, want = get_config(name), jget(name)
        assert dataclasses.asdict(got.optim) == dataclasses.asdict(want.optim)
        for field in ("model", "dataset", "global_batch_size", "image_size",
                      "num_classes", "num_steps", "seed", "accum_steps",
                      "label_smoothing"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    # tpudl's initializers: he_normal convolutions, lecun_normal head,
    # each block's last BatchNorm scale 0.
    model = build_model("resnet50", 1000, device="cpu", dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.BottleneckResNetBlock_3.Conv_1.weight
    std = float(w.detach().std())
    assert abs(std - (2.0 / w[0].numel()) ** 0.5) < 0.05 * std
    bound = 2 * (2.0 / w[0].numel()) ** 0.5 / 0.8796
    assert float(w.detach().abs().max()) <= bound
    assert torch.all(model.BottleneckResNetBlock_3.BatchNorm_2.scale == 0)
    assert torch.all(model.BottleneckResNetBlock_3.BatchNorm_1.scale == 1)
    assert torch.all(model.bn_init.var == 1)
    assert torch.all(model.bn_init.mean == 0)
    head = float(model.head.weight.detach().std())
    assert abs(head - (1.0 / 2048) ** 0.5) < 0.05 * head
