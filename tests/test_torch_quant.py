"""tpudl_torch.quant against tpudl.quant on the CPU.

The same numpy-seeded weights (tpudl's ``model.init`` params through the
weight bridges) go through both packages: the rule classes select the
same leaves, the quantized pairs are bit-equal (tpudl's ``[in, out]``
kernels transposed), ``quant_dot``'s fused and reference forms match
tpudl's at 1e-5 in f32, a ``weight_dtype`` model handed a full-precision
tree is bit-identical to the plain one, quantized trees cross the
checkpoint store both ways, and the quantized BERT forward, the
quantized serving sessions (int8 / e4m3 weights, int8 weights over int8
KV pages) and the exported quantized programs match tpudl's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models.llama import LLAMA_TINY as J_TINY
from tpudl.models.llama import LlamaForCausalLM as JLlama
from tpudl.quant import dense as jdense
from tpudl.quant import quantize as jquant
from tpudl.serve import Request as JRequest
from tpudl.serve import ServeSession as JSession
from tpudl_torch.ft.store import CheckpointStore
from tpudl_torch.models import bert as tbert
from tpudl_torch.models import llama as tllama
from tpudl_torch.quant import dense as tdense
from tpudl_torch.quant import quantize as tquant
from tpudl_torch.serve import Request, ServeSession
from tpudl_torch.serve.api import assert_serving_parity

PROMPT_LEN = 8
SLOTS = 4
WEIGHT_DTYPES = ("int8", "fp8_e4m3")
#: tpudl's parity-grid tolerances against f32 full precision
#: (tests/test_quant.py INT8_ATOL / KV8_ATOL).
INT8_ATOL = 0.06
KV8_ATOL = 0.10
#: Port against tpudl on the same quantized f32 tree: the port's Llama
#: bridge band (tests/test_torch_llama.py).
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def llama():
    """(tpudl model, tpudl params, port model, port params), f32."""
    jmodel = JLlama(J_TINY(dtype=jnp.float32, max_seq_len=96))
    jparams = jmodel.init(jax.random.key(0),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    tmodel = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(dtype=torch.float32, max_seq_len=96),
        device="meta")
    tparams = tllama.params_from_tpudl(_np(jparams), dtype=torch.float32,
                                       device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def bert():
    from tpudl.models.bert import BertConfig, BertForSequenceClassification

    kw = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
              intermediate_size=128, max_position_embeddings=64,
              num_labels=2)
    jmodel = BertForSequenceClassification(BertConfig(dtype=jnp.float32,
                                                      **kw))
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    jparams = jmodel.init(jax.random.key(0), jnp.asarray(ids),
                          jnp.asarray(mask))["params"]
    return jmodel, jparams, kw, ids, mask


def _jpaths(tree, pred):
    out = []
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.append(jquant._path_str(path))
        if pred(leaf) else None,
        tree, is_leaf=jquant.is_quantized)
    return sorted(out)


def _requests(cls, n, seed):
    rng = np.random.default_rng(seed)
    return [cls(f"q{i}", rng.integers(1, 512, size=int(
        rng.integers(2, PROMPT_LEN + 1))).tolist(),
        max_new_tokens=int(rng.integers(4, 16))) for i in range(n)]


def _same_bits(a: torch.Tensor, b: np.ndarray) -> bool:
    b = np.ascontiguousarray(b)
    return a.contiguous().view(torch.uint8).numpy().tobytes() == \
        b.view(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# 1. rules and the quantized leaves
# ---------------------------------------------------------------------------


def test_llama_rule_classes_match_tpudl(llama):
    jmodel, jparams, tmodel, tparams = llama
    jq = jquant.quantize_tree(jparams,
                              jquant.default_quant_rules(jmodel.cfg, "int8"))
    tq = tquant.quantize_tree(tparams,
                              tquant.default_quant_rules(tmodel.cfg, "int8"),
                              tllama.tpudl_path)
    got = sorted(tllama.tpudl_path(n) for n, leaf
                 in tquant.logical_leaves(tq) if tquant.is_quantized(leaf))
    assert got == _jpaths(jq, jquant.is_quantized)
    assert len(got) == tmodel.cfg.num_layers * 7
    matched = tquant.match_quant_rules(
        tquant.default_quant_rules(tmodel.cfg, "int8"), tparams,
        tllama.tpudl_path)
    assert sorted(tllama.tpudl_path(n) for n, d in matched.items() if d) == got


def test_bert_rule_classes_match_tpudl(bert):
    jmodel, jparams, kw, _, _ = bert
    tcfg = tbert.BertConfig(dtype=torch.float32, **kw)
    tparams = tbert.params_from_tpudl(_np(jparams), device="cpu")
    jq = jquant.quantize_tree(jparams,
                              jquant.default_quant_rules(jmodel.cfg, "int8"))
    tq = tquant.quantize_tree(tparams, tquant.default_quant_rules(tcfg, "int8"),
                              tbert.tpudl_path)
    got = sorted(tbert.tpudl_path(n) for n, leaf in tquant.logical_leaves(tq)
                 if tquant.is_quantized(leaf))
    assert got == _jpaths(jq, jquant.is_quantized)
    assert len(got) == tcfg.num_layers * 6


@pytest.mark.parametrize("wd", WEIGHT_DTYPES)
def test_quantized_leaves_bit_equal_to_tpudl(llama, wd):
    """Every pair: qvalues tpudl's transposed and qscale tpudl's, bit for
    bit; the bridge maps tpudl's quantized tree onto the same state_dict."""
    jmodel, jparams, tmodel, tparams = llama
    jq = jquant.quantize_tree(jparams,
                              jquant.default_quant_rules(jmodel.cfg, wd))
    tq = tquant.quantize_tree(tparams, tquant.default_quant_rules(
        tmodel.cfg, wd), tllama.tpudl_path)
    bridged = tllama.params_from_tpudl(_np(jq), dtype=torch.float32,
                                       device="cpu")
    assert set(bridged) == set(tq)
    for name, t in tq.items():
        assert t.dtype == bridged[name].dtype, name
        assert _same_bits(t, bridged[name].numpy() if t.dtype != torch.float8_e4m3fn
                          else bridged[name].view(torch.uint8).numpy()), name
    leaf = jq["model"]["layer_1"]["down_proj"]["kernel"]
    assert _same_bits(tq["model.layer_1.down_proj.qvalues"],
                      np.asarray(leaf["qvalues"]).T)
    assert _same_bits(tq["model.layer_1.down_proj.qscale"],
                      np.asarray(leaf["qscale"]))
    # The state_dict names map back to tpudl's pair paths.
    assert tllama.tpudl_path("model.layer_1.down_proj.qvalues") == \
        "model/layer_1/down_proj/kernel/qvalues"


def test_int8_roundtrip_bound():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 96)).astype(np.float32) * \
        np.linspace(0.01, 3.0, 48, dtype=np.float32)[:, None]
    leaf = tquant.quantize_leaf(torch.from_numpy(w), "int8")
    assert leaf["qvalues"].dtype == torch.int8
    assert tuple(leaf["qscale"].shape) == (48,)
    err = np.abs(tquant.dequantize_leaf(leaf).numpy() - w)
    bound = 0.5 * leaf["qscale"].numpy()[:, None] + 1e-7
    assert np.all(err <= bound), float((err - bound).max())


def test_fp8_roundtrip_bound():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(32, 64)).astype(np.float32) * \
        np.linspace(0.05, 2.0, 32, dtype=np.float32)[:, None]
    leaf = tquant.quantize_leaf(torch.from_numpy(w), "fp8_e4m3")
    assert leaf["qvalues"].dtype == torch.float8_e4m3fn
    deq = tquant.dequantize_leaf(leaf).numpy()
    bound = np.abs(w) * 2.0**-3 + leaf["qscale"].numpy()[:, None] * 2.0**-8
    assert np.all(np.abs(deq - w) <= bound)


def test_rules_refuse_uncovered_leaf():
    params = {"mystery.weight": torch.ones(4, 4)}
    with pytest.raises(ValueError, match="no quantization rule"):
        tquant.quantize_tree(params, ((r"other/kernel$", "int8"),))
    with pytest.raises(ValueError, match="weight_dtype must be one of"):
        tquant.quantize_leaf(torch.ones(4, 4), "int4")
    with pytest.raises(ValueError, match=">=2-D"):
        tquant.quantize_leaf(torch.ones(4), "int8")


def test_quantize_idempotent_and_dequantize_inverse(llama):
    _, _, tmodel, tparams = llama
    rules = tquant.default_quant_rules(tmodel.cfg, "int8")
    once = tquant.quantize_tree(tparams, rules, tllama.tpudl_path)
    twice = tquant.quantize_tree(once, rules, tllama.tpudl_path)
    assert list(once) == list(twice)
    assert all(once[k] is twice[k] for k in once)
    deq = tquant.dequantize_tree(once)
    assert set(deq) == set(tparams)
    assert all(deq[k].shape == tparams[k].shape for k in deq)


def test_weight_bytes_report_matches_tpudl(llama):
    jmodel, jparams, tmodel, tparams = llama
    jq = jquant.quantize_tree(jparams,
                              jquant.default_quant_rules(jmodel.cfg, "int8"))
    _, tq = tquant.quantize_model(tmodel, tparams, "int8")
    report = tquant.weight_bytes_report(tq)
    assert report == jquant.weight_bytes_report(jq)
    assert report["num_quantized_leaves"] == tmodel.cfg.num_layers * 7
    assert report["quant_ratio"] >= 3.5


# ---------------------------------------------------------------------------
# 2. the product and the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd", WEIGHT_DTYPES)
@pytest.mark.parametrize("impl", ["fused", "reference"])
def test_quant_dot_matches_tpudl(wd, impl):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    jleaf = jquant.quantize_leaf(jnp.asarray(w), wd)
    want = np.asarray(jdense.quant_dot(jnp.asarray(x), jleaf, impl=impl))
    tleaf = tquant.quantize_leaf(torch.from_numpy(w.T.copy()), wd)
    # On a CPU tensor "auto" runs the plain twin of the fused form.
    got = tdense.quant_dot(torch.from_numpy(x), tleaf,
                           impl="auto" if impl == "fused" else impl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    other = np.asarray(jdense.quant_dot(
        jnp.asarray(x), jleaf,
        impl="reference" if impl == "fused" else "fused"))
    np.testing.assert_allclose(got.numpy(), other, rtol=1e-5, atol=1e-5)


def test_quant_dot_dispatch():
    leaf = tquant.quantize_leaf(torch.randn(8, 16), "int8")
    x = torch.randn(3, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tdense.quant_dot(x, leaf, impl="fused")
    with pytest.raises(ValueError, match="impl"):
        tdense.quant_dot(x, leaf, impl="pallas")
    assert tdense.resolve_impl("auto") == "fused"
    from tpudl_torch.ops.quant_dot import quant_matmul

    before = quant_matmul.launches
    y = tdense.quant_dot(x, leaf)
    assert quant_matmul.launches == before  # the plain twin, no kernel
    assert y.shape == (3, 8) and y.dtype == torch.float32
    # A plain weight contracts in the compute dtype.
    w = torch.randn(8, 16)
    torch.testing.assert_close(tdense.quant_dot(x, w), x @ w.t())
    # The gradient reaches x through the op (a LoRA over a quantized base).
    xg = x.clone().requires_grad_(True)
    tdense.quant_dot(xg, leaf).sum().backward()
    want = tquant.dequantize_leaf(leaf).sum(0).expand(3, 16)
    torch.testing.assert_close(xg.grad, want, rtol=1e-5, atol=1e-5)


def test_weight_dtype_model_full_precision_params_bitident(llama):
    _, _, tmodel, tparams = llama
    ids = torch.arange(1, PROMPT_LEN + 1)[None, :]
    plain = tllama.LlamaForCausalLM(tmodel.cfg, device="cpu")
    plain.load_state_dict(tparams)
    quant = tllama.LlamaForCausalLM(
        dataclasses.replace(tmodel.cfg, weight_dtype="int8"), device="cpu")
    assert set(quant.state_dict()) == set(tparams)
    quant.load_state_dict(tparams)
    with torch.no_grad():
        assert torch.equal(plain(ids)[0], quant(ids)[0])


def test_quantized_model_forward_matches_tpudl(llama):
    """The port's int8 model on its own quantized tree against tpudl's
    quantized model, and the same module rebound full precision (the
    dispatch follows what the state_dict holds)."""
    jmodel, jparams, tmodel, tparams = llama
    jq_model, jq = jquant.quantize_model(jmodel, jparams, "int8")
    tq_model, tq = tquant.quantize_model(tmodel, tparams, "int8")
    ids = np.random.default_rng(6).integers(1, 512, (2, 12)).astype(np.int32)
    want = np.asarray(jq_model.apply({"params": jq}, jnp.asarray(ids)))
    tllama.bind_params(tq_model, tq)
    with torch.no_grad():
        got = tq_model(torch.from_numpy(ids))[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tq_model.model.layer_0.attention.q_proj.quantized
    tllama.bind_params(tq_model, tparams)
    assert not tq_model.model.layer_0.attention.q_proj.quantized
    with torch.no_grad():
        full = tq_model(torch.from_numpy(ids))[0]
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jmodel.apply({"params": jparams},
                                              jnp.asarray(ids))), **TOL)


def test_lora_over_quantized_base_matches_tpudl():
    """weight_dtype with lora_rank: the base product runs quant_dot over
    the quantized pair, the adapters full precision on top."""
    jcfg = J_TINY(dtype=jnp.float32, lora_rank=4, weight_dtype="int8")
    jmodel = JLlama(jcfg)
    jparams = jmodel.init(jax.random.key(1),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    rng = np.random.default_rng(8)
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                                 * 0.05)
        if "lora_b" in jax.tree_util.keystr(p) else v, jparams)
    jq = jquant.quantize_tree(jparams, jquant.default_quant_rules(jcfg, "int8"))
    ids = rng.integers(1, 512, (1, 10)).astype(np.int32)
    want = np.asarray(jmodel.apply({"params": jq}, jnp.asarray(ids)))
    tmodel = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(dtype=torch.float32, lora_rank=4,
                          weight_dtype="int8"), device="meta")
    tq = tllama.params_from_tpudl(_np(jq), dtype=torch.float32, device="cpu")
    assert "model.layer_0.gate_proj.lora_a" in tq
    tllama.bind_params(tmodel, tq)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))[0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bert_quantized_forward_matches_tpudl(bert):
    """BERT int8 (and e4m3) weights, fused and composite: the port's
    logits against tpudl's quantized model on the same tree (tight), and
    against f32 within tpudl's 0.05 quantization band."""
    jmodel, jparams, kw, ids, mask = bert
    tparams = tbert.params_from_tpudl(_np(jparams), device="cpu")
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    for wd in WEIGHT_DTYPES:
        jq_model, jq = jquant.quantize_model(jmodel, jparams, wd)
        want = np.asarray(jq_model.apply({"params": jq}, jnp.asarray(ids),
                                         jnp.asarray(mask)))
        for fused in (False, True):
            tmodel = tbert.BertForSequenceClassification(tbert.BertConfig(
                dtype=torch.float32, fused_ops=fused, **kw), device="meta")
            qmodel, tq = tquant.quantize_model(tmodel, tparams, wd)
            assert qmodel.cfg.weight_dtype == wd
            qmodel.load_state_dict(tq, strict=True, assign=True)
            qmodel.eval()
            with torch.no_grad():
                got = qmodel(torch.from_numpy(ids),
                             torch.from_numpy(mask)).numpy()
            np.testing.assert_allclose(got, want, **TOL)
            np.testing.assert_allclose(got, ref, atol=0.05)
        # tpudl's own quantized tree through the bridge: the same pairs.
        bridged = tbert.params_from_tpudl(_np(jq), device="cpu")
        assert set(bridged) == set(tq)
        assert all(_same_bits(tq[k], bridged[k].view(torch.uint8).numpy()
                              if bridged[k].dtype == torch.float8_e4m3fn
                              else bridged[k].numpy()) for k in tq)


@pytest.mark.parametrize("wd", WEIGHT_DTYPES)
def test_checkpoint_store_roundtrips_quantized_tree(llama, tmp_path, wd):
    """The port's store writes a quantized state_dict under tpudl's paths
    and tpudl's store reads the same bytes (e4m3 through ml_dtypes); the
    reverse direction gives the port the same tensors back."""
    from tpudl.ft.store import CheckpointStore as JStore

    jmodel, jparams, tmodel, tparams = llama
    _, tq = tquant.quantize_model(tmodel, tparams, wd)
    leaves = [(tllama.tpudl_path(k), v) for k, v in tq.items()]
    CheckpointStore(str(tmp_path / "t")).write(1, leaves)
    _, jgot = JStore(str(tmp_path / "t")).read(1)
    jq = jquant.quantize_tree(jparams,
                              jquant.default_quant_rules(jmodel.cfg, wd))
    jleaf = jq["model"]["layer_0"]["attention"]["k_proj"]["kernel"]
    got = jgot["model/layer_0/attention/k_proj/kernel/qvalues"]
    assert got.dtype == np.asarray(jleaf["qvalues"]).dtype
    np.testing.assert_array_equal(got.view(np.uint8),
                                  np.asarray(jleaf["qvalues"]).T.view(np.uint8))
    JStore(str(tmp_path / "j")).write(2, list(jgot.items()))
    _, back = CheckpointStore(str(tmp_path / "j")).read(2)
    for name, t in tq.items():
        b = back[tllama.tpudl_path(name)]
        assert b.dtype == t.dtype, name
        assert torch.equal(b.view(torch.uint8) if t.dtype ==
                           torch.float8_e4m3fn else b,
                           t.view(torch.uint8) if t.dtype ==
                           torch.float8_e4m3fn else t), name


# ---------------------------------------------------------------------------
# 3. serving: live sessions and exported programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(weight_dtype="int8"),
    dict(weight_dtype="fp8_e4m3"),
    dict(weight_dtype="int8", paged=True, kv_dtype="int8"),
], ids=["int8", "fp8_e4m3", "int8_kv8"])
def test_quantized_serving_matches_tpudl(llama, kw):
    """The same requests through tpudl's and the port's quantized
    sessions: the same greedy tokens and schedule; the port's session
    also holds tpudl's parity contract against f32 generate()."""
    jmodel, jparams, tmodel, tparams = llama
    js = JSession.from_model(jmodel, jparams, prompt_len=PROMPT_LEN,
                             num_slots=SLOTS, **kw)
    ts = ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                 num_slots=SLOTS, **kw)
    jres = js.serve(_requests(JRequest, 6, 1))
    tres = ts.serve(_requests(Request, 6, 1))
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
    for attr in ("num_prefills", "num_decode_steps"):
        assert getattr(ts.engine, attr) == getattr(js.engine, attr), attr
    assert ts.engine.cache.paged == bool(kw.get("paged"))
    if kw.get("kv_dtype"):
        assert ts.engine.cache.quantized
    atol = KV8_ATOL if kw.get("kv_dtype") else INT8_ATOL
    fresh = ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                    num_slots=SLOTS, **kw)
    assert_serving_parity(fresh, tmodel, tparams, _requests(Request, 3, 2),
                          atol=atol)


def test_quantized_params_pass_through_and_knobs(llama, monkeypatch):
    _, _, tmodel, tparams = llama
    qmodel, tq = tquant.quantize_model(tmodel, tparams, "int8")
    monkeypatch.setenv("TPUDL_SERVE_WEIGHT_DTYPE", "int8")
    monkeypatch.setenv("TPUDL_SERVE_KV_DTYPE", "int8")
    session = ServeSession.from_model(qmodel, tq, prompt_len=PROMPT_LEN,
                                      num_slots=2, paged=True)
    assert session.engine.cache.quantized
    assert session.serve(_requests(Request, 2, 5))["q0"].ok
    with pytest.raises(ValueError, match="require paged"):
        ServeSession.from_model(qmodel, tq, prompt_len=PROMPT_LEN,
                                num_slots=2)


@pytest.mark.parametrize("paged", [False, True])
def test_exported_quantized_decoder_parity(llama, paged):
    """The quantized dense and paged int8 programs export (their products
    are tpudl::quant_dot nodes), serve from artifacts with the tokens of
    the model session, and hold tpudl's parity contract."""
    from tpudl_torch.export.decode import export_serving_decoder
    from tpudl_torch.export.export import load_exported_obj
    from tpudl_torch.ops.library import graph_ops

    _, _, tmodel, tparams = llama
    qmodel, tq = tquant.quantize_model(tmodel, tparams, "int8")
    kw = dict(paged=True, kv_dtype="int8") if paged else {}
    pre, dec = export_serving_decoder(qmodel, tq, SLOTS, PROMPT_LEN, **kw)
    ops = graph_ops(load_exported_obj(dec).graph_module)
    assert ops.get("quant_dot") == tmodel.cfg.num_layers * 7
    art = ServeSession.from_artifacts(pre, dec, tq, paged=paged)
    assert art.engine.cache.paged == paged
    if paged:
        assert art.engine.cache.quantized
    live = ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                   num_slots=SLOTS, weight_dtype="int8", **kw)
    reqs = _requests(Request, 4, 3)
    ares, lres = art.serve(reqs), live.serve(_requests(Request, 4, 3))
    for rid in lres:
        assert ares[rid].tokens == lres[rid].tokens, rid
    fresh = ServeSession.from_artifacts(pre, dec, tq, paged=paged)
    assert_serving_parity(fresh, tmodel, tparams, _requests(Request, 2, 4),
                          atol=KV8_ATOL if paged else INT8_ATOL)


# ---------------------------------------------------------------------------
# 4. int8 KV pages
# ---------------------------------------------------------------------------


def test_quantize_kv_bit_equal_to_tpudl():
    from tpudl.models import paged as jpaged
    from tpudl_torch.models import paged as tpaged

    x = np.random.default_rng(12).normal(size=(3, 5, 2, 16)).astype(
        np.float32)
    x[1, 2, 0] = 0.0  # an all-zero head: the scale floor
    jq, js = jpaged.quantize_kv(jnp.asarray(x))
    tq, ts = tpaged.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_paged_write_and_gather_match_tpudl():
    """tpudl's quantized write (quantize on the way in) and dequantizing
    gather against the port's in-place ones: pages and scale pools bit
    for bit (page 0, the trash page, aside), the gathered rows exact."""
    from tpudl.models import paged as jpaged
    from tpudl_torch.models import paged as tpaged

    rng = np.random.default_rng(13)
    pages = np.zeros((7, 4, 2, 3), np.int8)
    scales = np.zeros((7, 4, 2), np.float32)
    table = np.array([[1, 5, 0], [2, 3, 6], [0, 0, 0]], np.int32)
    start = np.array([1, 0, 0], np.int32)
    lens = np.array([5, 9, 0], np.int32)
    value = rng.normal(size=(3, 2, 2, 3)).astype(np.float32)
    jview = jpaged.PagedView(jnp.asarray(table), jnp.asarray(start),
                             jnp.asarray(lens), 4, True)
    view = tpaged.PagedView(*(torch.from_numpy(a).long()
                              for a in (table, start, lens)), 4, True)
    jp, js = jpaged.paged_write(jnp.asarray(pages), jnp.asarray(scales),
                                jnp.asarray(value), jview)
    tp, ts = tpaged.paged_write(torch.from_numpy(pages.copy()),
                                torch.from_numpy(scales.copy()),
                                torch.from_numpy(value), view)
    np.testing.assert_array_equal(tp[1:].numpy(), np.asarray(jp)[1:])
    np.testing.assert_array_equal(ts[1:].numpy(), np.asarray(js)[1:])
    np.testing.assert_array_equal(
        tpaged.paged_gather(tp, ts, view, torch.float32)[:2].numpy(),
        np.asarray(jpaged.paged_gather(jp, js, jview, jnp.float32))[:2])


def test_int8_paged_cache_seat_and_free(llama):
    """PagedKVCache(kv_dtype="int8"): int8 pools with f32 scale pools,
    the prompt quantized as it is seated (tpudl's quantize_kv of the
    row's pages), nbytes counting the scale pools, free returning the
    pages."""
    from tpudl.models import paged as jpaged
    from tpudl_torch.models.llama import init_cache
    from tpudl_torch.serve.cache import PagedKVCache

    _, _, tmodel, _ = llama
    template = init_cache(tmodel.cfg, 2, device="meta")
    cache = PagedKVCache(template, page_size=16, num_pages=9,
                         kv_dtype="int8", device="cpu")
    pool = cache.cache["model"]["layer_0"]["attention"]
    assert set(pool) == {"pages_k", "pages_v", "scale_k", "scale_v"}
    assert pool["pages_k"].dtype == torch.int8
    assert tuple(pool["scale_k"].shape) == (9, 16, tmodel.cfg.num_kv_heads)
    want = sum(t.numel() * t.element_size()
               for layer in cache.cache["model"].values()
               for t in layer["attention"].values())
    assert cache.nbytes == want + cache.page_table.nbytes + \
        cache.start.nbytes + cache.lens.nbytes
    rng = np.random.default_rng(14)
    row = init_cache(tmodel.cfg, 1, device="cpu")
    for layer in row["model"].values():
        for kv in ("k", "v"):
            layer["attention"][kv] = torch.from_numpy(rng.normal(
                size=tuple(layer["attention"][kv].shape)).astype(np.float32))
    cache.seat(row, 1, pad=2, prompt_len=20, reserve_tokens=40)
    assert cache.free_pages == 5 and cache.lens[1] == 20
    pages = cache.page_table[1, :2]
    blocks = row["model"]["layer_0"]["attention"]["k"][0, :32].numpy()
    jq, js = jpaged.quantize_kv(jnp.asarray(blocks.reshape(2, 16, *blocks.shape[1:])))
    np.testing.assert_array_equal(pool["pages_k"][torch.from_numpy(
        pages.astype(np.int64))].numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pool["scale_k"][torch.from_numpy(
        pages.astype(np.int64))].numpy(), np.asarray(js))
    cache.free(1)
    assert cache.free_pages == 8 and not cache.page_table[1].any()


# The TMA product's launch plan (tpudl_torch.ops.quant_dot.gemm_plan): the
# K steps of 64 cut into splits whose f32 partials the split sum adds in
# a fixed order; the plan must cover every K step exactly once and depend
# on the shape alone.
GEMM_PLAN_SHAPES = [(m, k, n) for m in (17, 128, 129, 4099, 32768)
                    for k, n in ((256, 192), (4112, 1000), (4096, 4096),
                                 (4096, 1024), (4096, 14336), (14336, 4096),
                                 (768, 768), (768, 3072), (3072, 768))]


def _split_ranges(plan):
    """The K steps ``[first, end)`` of each split of ``plan``, as
    csrc/quant_dot.cu assigns them, in the order the split sum adds
    their partials."""
    return [(s * plan["per"], min((s + 1) * plan["per"], plan["ksteps"]))
            for s in range(plan["split"])]


@pytest.mark.parametrize("m,k,n", GEMM_PLAN_SHAPES)
def test_gemm_plan_covers_every_k_step_once(m, k, n):
    from tpudl_torch.ops import quant_dot as qd

    plan = qd.gemm_plan(m, n, k)
    tm, tn, tk = qd.TMA_TILE
    assert plan["ksteps"] == -(-k // tk)
    assert plan["rows"] in (tm, qd.TMA_TALL_ROWS)
    if plan["rows"] == qd.TMA_TALL_ROWS:
        assert plan["tiles"] >= 132
    assert plan["tiles"] == -(-m // plan["rows"]) * -(-n // tn)
    ranges = _split_ranges(plan)
    assert len(ranges) == plan["split"]
    steps = [s for first, end in ranges for s in range(first, end)]
    assert steps == list(range(plan["ksteps"]))
    assert all(end > first for first, end in ranges)
    if plan["split"] > 1:
        # Split only where the tiles leave multiprocessors idle, within
        # one wave, each split at least MIN_SPLIT_STEPS long but the last.
        assert plan["units"] <= 132
        assert all(end - first >= qd.MIN_SPLIT_STEPS
                   for first, end in ranges[:-1])
        assert plan["ws"] == plan["split"] * m * n
    else:
        assert plan["ws"] == 0
    assert plan["units"] == plan["tiles"] * plan["split"]
    assert 1 <= plan["grid"] <= min(plan["units"], 132)


def test_gemm_plan_tile_matches_the_kernel_source():
    """gemm_plan's tile is the one csrc/quant_dot.cu was compiled with."""
    from tests.csrc_helpers import csrc_constants
    from tpudl_torch.ops import quant_dot as qd

    c = csrc_constants("quant_dot")
    assert qd.TMA_TILE == (c["kTmaRows"], c["kTmaChannels"], c["kTmaK"])
    assert qd.TMA_TALL_ROWS == c["kTmaTallRows"]


def test_gemm_plan_depends_on_the_shape_alone():
    """The same shape always gets the same plan; a prefill's M = 128
    splits K, BERT's M = 32768 does not."""
    from tpudl_torch.ops import quant_dot as qd

    for m, k, n in ((128, 4096, 4096), (128, 4096, 1024), (32768, 768, 3072)):
        assert qd.gemm_plan(m, n, k) == qd.gemm_plan(m, n, k)
    assert qd.gemm_plan(128, 4096, 4096)["split"] > 1
    assert qd.gemm_plan(128, 1024, 4096)["split"] > 1
    assert qd.gemm_plan(128, 4096, 4096)["rows"] == 128
    bert = qd.gemm_plan(32768, 3072, 768)
    assert bert["split"] == 1 and bert["rows"] == qd.TMA_TALL_ROWS


# The tensor-core GEMV's launch plan (tpudl_torch.ops.quant_dot.gemv_plan):
# K steps of 64 cut into one slice a warp, the warps of a CTA taking
# consecutive slices, whose f32 partials are summed in warp order; channel
# tiles of 16 (or 8) cut into groups, one a CTA. The four decode shapes, M
# 1 to 16, ragged N and K (1000, 4112) and small shapes that take tiles of
# 8 or few warps.
GEMV_PLAN_SHAPES = [(m, k, n) for m in (1, 4, 5, 9, 16)
                    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4112, 1000), (4096, 256),
                                 (256, 192), (64, 70))]


def _gemv_slices(plan):
    """Each slice's K steps ``[first, end)``, in the order the kernel sums
    their partials (warp w takes slice w)."""
    ks, sl = plan["ksteps"], plan["warps"]
    return [(s * ks // sl, (s + 1) * ks // sl) for s in range(sl)]


@pytest.mark.parametrize("m,k,n", GEMV_PLAN_SHAPES)
def test_gemv_plan_covers_every_channel_and_k_step_once(m, k, n):
    from tpudl_torch.ops import quant_dot as qd

    plan = qd.gemv_plan(m, n, k)
    assert plan["nb"] == (1 if m <= 8 else 2)
    assert plan["ksteps"] == -(-k // qd.GEMV_STEP_K)
    assert 1 <= plan["warps"] <= qd.GEMV_MAX_WARPS // plan["nb"]
    ranges = _gemv_slices(plan)
    assert all(end > first for first, end in ranges)  # no empty slice
    assert [s for first, end in ranges for s in range(first, end)] == \
        list(range(plan["ksteps"]))
    longest = max(end - first for first, end in ranges)
    assert plan["rounds"] == -(-longest // qd.GEMV_STEPS)
    # Channels: group g takes tiles [g * tiles, (g + 1) * tiles) of
    # ``height``: 8 where tiles of 16 leave half the card idle.
    h = plan["height"]
    assert h == (qd.GEMV_TILE if -(-n // qd.GEMV_TILE) * 2 > 132
                 else qd.GEMV_HALF_TILE)
    assert plan["ntiles"] == -(-n // h)
    assert 1 <= plan["tiles"] <= qd.GEMV_MAX_TILES
    assert plan["groups"] == -(-plan["ntiles"] // plan["tiles"])
    chans = [c for gi in range(plan["groups"])
             for t in range(gi * plan["tiles"],
                            min((gi + 1) * plan["tiles"], plan["ntiles"]))
             for c in range(t * h, (t + 1) * h) if c < n]
    assert chans == list(range(n))
    assert plan["grid"] == plan["groups"]
    assert plan["smem"] == (plan["warps"] * 8 * plan["nb"]
                            * (plan["tiles"] * h + qd.GEMV_PAD) * 4)
    assert plan["smem"] <= 232448


@pytest.mark.parametrize("m,k,n", GEMV_PLAN_SHAPES)
def test_gemv_plan_splits_k_only_across_the_warps_of_a_cta(m, k, n):
    """Every CTA sums all of K itself, over as many warps as its registers
    take (16, 8 for 9-16 rows of x) or K has steps: a cluster of 1, no
    reduction across CTAs, so the kernel sets no cluster launch attribute
    and reads no other CTA's shared memory."""
    from tpudl_torch.ops import _build
    from tpudl_torch.ops import quant_dot as qd

    plan = qd.gemv_plan(m, n, k)
    assert plan["warps"] == min(qd.GEMV_MAX_WARPS // plan["nb"],
                                plan["ksteps"])
    assert "cluster" not in plan and "cluster" not in qd.GEMV_ARGS
    assert _gemv_slices(plan)[-1][1] == plan["ksteps"]
    src = (_build.CSRC / "quant_dot.cu").read_text()
    assert "cudaLaunchAttributeClusterDimension" not in src
    assert "map_shared_rank" not in src


def test_gemv_plan_sizes_match_the_kernel_source():
    """gemv_plan's sizes are the ones csrc/quant_dot.cu was compiled with."""
    from tests.csrc_helpers import csrc_constants
    from tpudl_torch.ops import quant_dot as qd

    c = csrc_constants("quant_dot")
    assert (qd.GEMV_TILE, qd.GEMV_HALF_TILE, qd.GEMV_STEP_K, qd.GEMV_STEPS,
            qd.GEMV_MAX_WARPS, qd.GEMV_MAX_TILES, qd.GEMV_PAD) == (
        c["kGemvTile"], c["kGemvHalfTile"], c["kGemvStepK"], c["kGemvSteps"],
        c["kGemvMaxWarps"], c["kGemvMaxTiles"], c["kGemvPad"])


def test_gemv_plan_depends_on_the_shape_alone():
    """The same shape always gets the same plan; the decode shapes take a
    CTA of 16 warps a multiprocessor, N = 256 tiles of 8 channels, M = 16
    half the warps."""
    from tpudl_torch.ops import quant_dot as qd

    for m, k, n in GEMV_PLAN_SHAPES:
        assert qd.gemv_plan(m, n, k) == qd.gemv_plan(m, n, k)
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        plan = qd.gemv_plan(4, n, k)
        assert plan["warps"] == 16
        assert plan["grid"] <= 132
    assert qd.gemv_plan(4, 14336, 4096)["rounds"] == 1
    assert qd.gemv_plan(4, 4096, 14336)["rounds"] == 4
    narrow = qd.gemv_plan(4, 256, 4096)
    assert narrow["height"] == qd.GEMV_HALF_TILE and narrow["grid"] == 32
    assert qd.gemv_plan(16, 4096, 4096)["warps"] == 8


def test_gemv_route_is_chosen_by_operand():
    """bf16 x in whole 16-byte vectors takes the vector kernels (the
    tensor-core GEMV at M <= 16); f32 x, a ragged K or a misaligned x
    keep the FMA kernel."""
    from tpudl_torch.ops import quant_dot as qd

    q = torch.zeros(8, 64, dtype=torch.int8)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert qd.vector_route(x, q)
    assert not qd.vector_route(x.float(), q)
    assert not qd.vector_route(torch.zeros(4, 56, dtype=torch.bfloat16)[:, :50],
                             q[:, :50])
    assert not qd.vector_route(torch.zeros(4 * 64 + 1, dtype=torch.bfloat16)[1:]
                             .view(4, 64), q)
