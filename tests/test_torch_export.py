"""The port's export harness (tpudl_torch.export) against tpudl's on the
CPU.

ResNetTiny and BERT_TINY (f32, tpudl's weights through
``params_from_tpudl``) go export -> save -> load as ``torch.export``
programs with the parameters as inputs. The loaded program equals the
eager port at the reference's tolerances (rtol 1e-5, atol 1e-4) and
tpudl's exported StableHLO artifact of the same weights at the bridge's
(rtol 1e-4, atol 1e-5, tests/test_torch_resnet.py). The mappings
StableHLO -> ``.pt2`` and Orbax -> safetensors are pinned here: the
artifact holds ``tpudl::`` nodes and no weights, and the parameter file
is read and written by the ``safetensors`` library as well.
``compare_outputs``, ``LatencyStats`` and ``latency_benchmark`` give
tpudl's fields and keys for the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl import export as jexport
from tpudl.export import latency as jlatency
from tpudl.export import parity as jparity
from tpudl.models import bert as jbert
from tpudl.models import resnet as jresnet
from tpudl_torch import export as texport
from tpudl_torch.export import latency as tlatency
from tpudl_torch.export import parity as tparity
from tpudl_torch.export.export import load_exported_obj
from tpudl_torch.models import bert as tbert
from tpudl_torch.models import resnet as tresnet
from tpudl_torch.ops.library import graph_ops

pytestmark = pytest.mark.needs_jax_export

BRIDGE = dict(rtol=1e-4, atol=1e-5)
STRICT = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _roundtrip(tmp_path, fn, args, name):
    """Export to a file, save the params beside it, load both back."""
    path = str(tmp_path / f"{name}.pt2")
    blob = texport.export_program(fn, args, path=path)
    with open(path, "rb") as f:
        assert f.read() == blob
    params_path = str(tmp_path / f"{name}.safetensors")
    texport.save_params(params_path, args[0])
    params = texport.load_params(params_path, like=args[0])
    for k, v in args[0].items():
        assert torch.equal(params[k], v), k
    sizes = texport.artifact_sizes(path, params_path)
    return texport.load_exported(path), params, blob, sizes


def test_resnet_tiny_artifact_matches_eager_and_tpudl(tmp_path, one_thread):
    jmodel = jresnet.ResNetTiny(num_classes=10, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(x), train=False)

    def jforward(params, batch_stats, images):
        return jmodel.apply({"params": params, "batch_stats": batch_stats},
                            images, train=False)

    jargs = (variables["params"], variables["batch_stats"], jnp.asarray(x))
    want = np.asarray(jexport.load_exported(
        jexport.export_stablehlo(jforward, jargs))(*jargs))
    model = tresnet.ResNetTiny(num_classes=10, dtype=torch.float32,
                               device="meta")
    params = tresnet.params_from_tpudl(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]), device="cpu")
    fn = texport.forward_fn(model, train=False)
    loaded, saved, blob, sizes = _roundtrip(
        tmp_path, fn, (params, torch.as_tensor(x)), "resnet")
    got = loaded(saved, torch.as_tensor(x))
    eager = fn(params, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), eager.numpy(), **STRICT)
    np.testing.assert_allclose(got.numpy(), want, **BRIDGE)
    # Parameters are inputs: the program holds no weights (its constants
    # are a few scalars at most).
    assert sizes[str(tmp_path / "resnet.pt2")] == len(blob)
    program = load_exported_obj(blob)
    assert not program.state_dict
    assert sum(t.numel() for t in program.constants.values()
               if isinstance(t, torch.Tensor)) < 16


def test_bert_tiny_artifact_matches_eager_and_tpudl(tmp_path, one_thread):
    """BERT_TINY with the fused slice (fused_ops, attention "fused"):
    the eval forward's artifact holds tpudl::layer_norm, bias_gelu and
    softmax_dropout nodes (rate 0: no draw, no generator input), runs
    their plain versions on the CPU, and matches tpudl's artifact."""
    jcfg = jbert.BERT_TINY(num_labels=2, dtype=jnp.float32,
                           hidden_dropout=0.0, attention_dropout=0.0)
    jmodel = jbert.BertForSequenceClassification(jcfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 11:] = 0
    jparams = jmodel.init(jax.random.key(0), jnp.asarray(ids),
                          train=False)["params"]

    def jforward(params, input_ids, attention_mask):
        return jmodel.apply({"params": params}, input_ids, attention_mask,
                            train=False)

    jargs = (jparams, jnp.asarray(ids), jnp.asarray(mask))
    want = np.asarray(jexport.load_exported(
        jexport.export_stablehlo(jforward, jargs))(*jargs))
    model = tbert.BertForSequenceClassification(tbert.BERT_TINY(
        dtype=torch.float32, fused_ops=True, attention_impl="fused",
        hidden_dropout=0.0, attention_dropout=0.0), device="meta")
    params = tbert.params_from_tpudl(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    fn = texport.forward_fn(model, train=False)
    args = (params, torch.as_tensor(ids), torch.as_tensor(mask))
    loaded, saved, blob, _ = _roundtrip(tmp_path, fn, args, "bert")
    program = load_exported_obj(blob)
    assert graph_ops(program.graph_module) == {
        "layer_norm": 5, "bias_gelu": 2, "softmax_dropout": 2}
    assert [n for n in program.graph.nodes
            if "rand" in str(n.target) or "bernoulli" in str(n.target)] == []
    got = loaded(saved, *args[1:])
    np.testing.assert_allclose(got.numpy(), fn(*args).numpy(), **STRICT)
    np.testing.assert_allclose(got.numpy(), want, **BRIDGE)


def test_params_file_is_the_safetensors_format(tmp_path):
    """save_params writes what the safetensors library reads, and reads
    what it writes, bit for bit, bf16 and bool included; ``like`` fixes
    the order and refuses another key set, naming a key."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    params = {"b.w": torch.randn(3, 4, generator=g).bfloat16(),
              "a.mask": torch.rand(5, generator=g) > 0.5,
              "c": {"count": torch.arange(4), "x": torch.randn(2, 2,
                                                               generator=g)}}
    path = str(tmp_path / "mine.safetensors")
    texport.save_params(path, params)
    theirs = load_file(path)
    flat = {"b.w": params["b.w"], "a.mask": params["a.mask"],
            "c.count": params["c"]["count"], "c.x": params["c"]["x"]}
    assert set(theirs) == set(flat)
    for k, v in flat.items():
        assert torch.equal(theirs[k], v) and theirs[k].dtype == v.dtype, k
    other = str(tmp_path / "theirs.safetensors")
    save_file(flat, other)
    back = texport.load_params(other, like=params)
    assert list(back) == list(flat)
    for k, v in flat.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="c.x"):
        texport.load_params(other, like={k: v for k, v in flat.items()
                                         if k != "c.x"})
    assert texport.artifact_sizes(str(tmp_path))[str(tmp_path)] > 0
    missing = str(tmp_path / "nope.pt2")
    assert texport.artifact_sizes(missing)[missing] is None


def test_compare_outputs_and_latency_stats_match_tpudl():
    rng = np.random.default_rng(5)
    a = {"logits": rng.normal(size=(4, 3)).astype(np.float32),
         "loss": np.float32(1.5)}
    for b in ({"logits": a["logits"] + 0.01, "loss": np.float32(1.5)},
              {"logits": a["logits"] * (1 + 1e-7), "loss": np.float32(1.5)}):
        for tol in (dict(rtol=1e-5, atol=1e-4), dict(rtol=2e-2, atol=2e-2)):
            want = jparity.compare_outputs(a, b, backend_a="x",
                                           backend_b="y", **tol)
            got = tparity.compare_outputs(
                {k: torch.as_tensor(v) for k, v in a.items()}, b,
                backend_a="x", backend_b="y", **tol)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert str(got) == str(want)
    samples = rng.exponential(3.0, 101)
    got = tlatency.LatencyStats.from_ms(samples)
    want = jlatency.LatencyStats.from_ms(samples)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.as_dict() == want.as_dict()
    assert got.percentiles() == want.percentiles()
    assert (dataclasses.asdict(tlatency.LatencyStats.from_seconds(samples))
            == dataclasses.asdict(jlatency.LatencyStats.from_seconds(samples)))
    with pytest.raises(ValueError, match="at least one sample"):
        tlatency.LatencyStats.from_ms([])


def test_latency_benchmark_and_parity_harness(one_thread):
    """latency_benchmark returns tpudl's keys (transfer and compute timed
    apart, warm-up excluded); check_parity runs one artifact on two
    devices (here the CPU twice), strict mode restoring the TF32 flags."""
    w = torch.randn(8, 3)

    def fn(x, w):
        return torch.tanh(x @ w)

    x = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    got = tlatency.latency_benchmark(fn, (x, w), device="cpu", warmup=1,
                                     iters=3)
    want = jlatency.latency_benchmark(lambda x, w: jnp.tanh(x @ w),
                                      (x, w.numpy()), warmup=1, iters=3)
    assert set(got) == set(want)
    for window in ("transfer", "compute"):
        assert set(got[window]) == set(want[window])
        stats = got[window]
        assert stats["max_ms"] >= stats["p99_ms"] >= stats["p50_ms"] >= \
            stats["min_ms"] >= 0.0
    assert got["iters"] == 3 and got["warmup"] == 1
    blob = texport.export_program(fn, (torch.as_tensor(x), w))
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    report = tparity.check_parity(blob, (torch.as_tensor(x), w),
                                  device_a="cpu", device_b="cpu")
    assert report.ok and report.max_abs_err == 0.0, str(report)
    assert (report.backend_a, report.backend_b) == ("cpu", "cpu")
    assert flags == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
    assert tparity.assert_parity(blob, (torch.as_tensor(x), w),
                                 device_a="cpu", device_b="cpu",
                                 strict=False).ok
