"""tpudl_torch.models (Llama) against tpudl.models on the CPU.

tpudl's ``LlamaForCausalLM(LLAMA_TINY)`` params from ``model.init`` go
through ``params_from_tpudl`` into the port; the same left-padded
prompts then run through both packages' prefill and decode contracts.
Logits and the whole KV cache (k, v, valid, index) must agree: f32 at
rtol 1e-4 / atol 1e-5 (the BERT bridge's band, tests/test_bert.py:81),
bf16 at 5e-2. ``fused_ops`` True routes the port's norms and SwiGLU
through the kernel seam (the plain versions, on CPU tensors) and tpudl's
through its own ("auto": the composite off-TPU). The non-decode forward
and the LoRA sequence classifier are held the same way (the training
step is in tests/test_torch_train.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import llama as jllama
from tpudl_torch.models import llama as tllama

# The packages re-export a ``generate`` function under the module's name.
jgen = importlib.import_module("tpudl.models.generate")
tgen = importlib.import_module("tpudl_torch.models.generate")

MAX_SEQ = 64
B, S = 2, 8
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jax_params():
    model = jllama.LlamaForCausalLM(
        jllama.LLAMA_TINY(dtype=jnp.float32, max_seq_len=MAX_SEQ)
    )
    params = model.init(jax.random.key(0), jnp.zeros((1, S), jnp.int32))
    return jax.tree.map(np.asarray, params["params"])


def _models(jax_params, dtype, fused_ops):
    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(
        dtype=JAX_DTYPE[dtype], max_seq_len=MAX_SEQ, fused_ops=fused_ops))
    tmodel = tllama.LlamaForCausalLM(tllama.LLAMA_TINY(
        dtype=TORCH_DTYPE[dtype], max_seq_len=MAX_SEQ, fused_ops=fused_ops),
        device="meta")
    tparams = tllama.params_from_tpudl(jax_params, dtype=TORCH_DTYPE[dtype],
                                       device="cpu")
    return jmodel, tmodel, tparams


def _prompts():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 512, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0  # row 1 is left-padded
    ids[1, :3] = 0
    return ids, mask


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _assert_cache_equal(tcache, jcache, tol):
    layers = jcache["model"]
    assert set(tcache["model"]) == set(layers)
    for name, layer in layers.items():
        t = tcache["model"][name]["attention"]
        j = layer["attention"]
        assert int(t["index"]) == int(j["index"]), name
        np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(t[key]), _np(j[key]), **tol,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("fused_ops", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_tpudl(jax_params, dtype, fused_ops):
    jmodel, tmodel, tparams = _models(jax_params, dtype, fused_ops)
    tol = TOL[dtype]
    ids, mask = _prompts()
    jlogits, jcache = jgen.prefill_fn(jmodel)(
        jax_params, jnp.asarray(ids), jnp.asarray(mask))
    tlogits, tcache = tgen.prefill_fn(tmodel)(tparams, ids, mask)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **tol)
    _assert_cache_equal(tcache, jcache, tol)
    # Two decode steps, feeding both the same (tpudl's greedy) tokens.
    position = mask.sum(-1).astype(np.int32)
    token = np.array(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(2):
        jlogits, jcache = jgen.decode_fn(jmodel)(
            jax_params, jcache, jnp.asarray(token), jnp.asarray(position))
        tlogits, tcache = tgen.decode_fn(tmodel)(tparams, tcache, token,
                                                 position)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **tol)
        _assert_cache_equal(tcache, jcache, tol)
        token = np.array(jnp.argmax(jlogits, -1), np.int32)
        position = position + 1


@pytest.mark.parametrize("eos", [False, True])
def test_generate_greedy_tokens_match_tpudl(jax_params, eos):
    jmodel, tmodel, tparams = _models(jax_params, "float32", True)
    ids, mask = _prompts()
    want = np.asarray(jgen.generate(jmodel, jax_params, jnp.asarray(ids),
                                    jnp.asarray(mask), max_new_tokens=10))
    eos_id = int(want[0, 3]) if eos else None
    if eos:
        want = np.asarray(jgen.generate(
            jmodel, jax_params, jnp.asarray(ids), jnp.asarray(mask),
            max_new_tokens=10, eos_id=eos_id))
    got = tgen.generate(tmodel, tparams, ids, mask, max_new_tokens=10,
                        eos_id=eos_id)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rope_matches_tpudl():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 200, size=(2, 5)).astype(np.int32)
    want = jllama.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_params_from_tpudl_layout_and_dtypes(jax_params):
    params = tllama.params_from_tpudl(jax_params, dtype=torch.bfloat16,
                                      device="cpu")
    model = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(max_seq_len=MAX_SEQ), device="meta")
    assert set(params) == set(model.state_dict())
    q = params["model.layer_0.attention.q_proj.weight"]
    kernel = jax_params["model"]["layer_0"]["attention"]["q_proj"]["kernel"]
    assert q.dtype == torch.bfloat16 and tuple(q.shape) == kernel.T.shape
    np.testing.assert_allclose(q.float().numpy(), kernel.T, rtol=1e-2,
                               atol=1e-3)
    assert params["model.embed_tokens.weight"].dtype == torch.bfloat16
    assert params["lm_head.weight"].dtype == torch.float32
    assert params["model.final_norm.scale"].dtype == torch.float32
    lora = {"model": {"layer_0": {"q_proj": {"lora_a": np.zeros((4, 2))}}}}
    with pytest.raises(ValueError, match="no counterpart"):
        tllama.params_from_tpudl(lora, device="cpu")


def test_init_params_matches_the_module_and_tpudl_init():
    cfg = tllama.LLAMA_TINY(max_seq_len=MAX_SEQ)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    model = tllama.LlamaForCausalLM(cfg, device="meta")
    for name, p in model.state_dict().items():
        assert params[name].shape == p.shape and params[name].dtype == p.dtype
    assert torch.all(params["model.layer_1.input_norm.scale"] == 1)
    std = float(params["model.layer_0.gate_proj.weight"].float().std())
    assert 0.018 < std < 0.022  # normal(0.02), like tpudl's kernel_init


@pytest.mark.parametrize("field,value", [
    ("moe_experts", 8), ("weight_dtype", "int8"), ("fp8_train", True),
])
def test_unported_tiers_raise(field, value):
    cfg = tllama.LLAMA_TINY(**{field: value})
    if field == "fp8_train":
        # Ported since (tests/test_torch_precision.py): the tier builds,
        # and it refuses the quantized weight tier, as tpudl's.
        tllama.LlamaForCausalLM(cfg, device="meta")
        with pytest.raises(ValueError, match="does not compose"):
            tllama.LlamaForCausalLM(tllama.LLAMA_TINY(
                fp8_train=True, weight_dtype="int8"), device="meta")
        return
    # Ported since (tests/test_torch_moe.py, tests/test_torch_quant.py):
    # the tier builds; an unknown setting of it raises.
    model = tllama.LlamaForCausalLM(cfg, device="meta")
    if field == "moe_experts":
        assert hasattr(model.model.layer_0, "moe")
        assert not hasattr(model.model.layer_0, "gate_proj")
        bad = {field: -1}
    else:
        assert model.model.layer_0.attention.q_proj.qvalues is None
        bad = {field: "int4"}
    with pytest.raises(ValueError, match="must be"):
        tllama.LlamaForCausalLM(tllama.LLAMA_TINY(**bad), device="meta")


def test_non_decode_forward_is_not_ported(jax_params):
    """The non-decode forward is ported for the reference and flash
    attention implementations; the sequence-parallel ones are not."""
    tmodel = tllama.LlamaForCausalLM(tllama.LLAMA_TINY(
        dtype=torch.float32, max_seq_len=MAX_SEQ, attention_impl="ring"),
        device="meta")
    tllama.bind_params(tmodel, tllama.params_from_tpudl(
        jax_params, dtype=torch.float32, device="cpu"))
    with pytest.raises(NotImplementedError, match="item 10"):
        tmodel(torch.zeros(1, 4, dtype=torch.long))


def test_presets_mirror_tpudl():
    for name, preset in tllama.LLAMA_SIZES.items():
        t, j = preset(), jllama.LLAMA_SIZES[name]()
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "num_kv_heads", "intermediate_size", "max_seq_len",
                      "rope_theta", "rms_norm_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)


def test_bind_params_refuses_a_dtype_mismatch(jax_params):
    tmodel = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(dtype=torch.bfloat16, max_seq_len=MAX_SEQ),
        device="meta")
    f32 = tllama.params_from_tpudl(jax_params, dtype=torch.float32,
                                   device="cpu")
    with pytest.raises(ValueError, match="dtypes do not match"):
        tllama.bind_params(tmodel, f32)


# ---------------------------------------------------------------------------
# the non-decode forward, LoRA and the sequence classifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_non_decode_forward_matches_tpudl(jax_params, attention_impl):
    """LlamaForCausalLM without decode, on the left-padded prompts: f32
    logits at the decode test's band (flash in tpudl's interpret mode)."""
    cfg = dict(dtype=jnp.float32, max_seq_len=MAX_SEQ,
               attention_impl=attention_impl)
    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(**cfg))
    cfg["dtype"] = torch.float32
    tmodel = tllama.LlamaForCausalLM(tllama.LLAMA_TINY(**cfg), device="meta")
    tllama.bind_params(tmodel, tllama.params_from_tpudl(
        jax_params, dtype=torch.float32, device="cpu"))
    ids, mask = _prompts()
    want = jmodel.apply({"params": jax_params}, jnp.asarray(ids),
                        jnp.asarray(mask))
    got, cache = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


_CLS_CFG = dict(num_labels=3, lora_rank=4, vocab_size=128, max_seq_len=64)


@pytest.fixture(scope="module")
def cls_params():
    """A tpudl LoRA classifier tree with ``lora_b`` drawn non-zero (with
    tpudl's zero init the adapters would change nothing)."""
    model = jllama.LlamaForSequenceClassification(
        jllama.LLAMA_TINY(dtype=jnp.float32, **_CLS_CFG))
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(1), jnp.zeros((1, S), jnp.int32))["params"])
    rng = np.random.default_rng(5)

    def fill(node):
        for key, value in node.items():
            if isinstance(value, dict):
                fill(value)
            elif key == "lora_b":
                node[key] = (0.05 * rng.normal(size=value.shape)).astype(
                    np.float32)

    fill(params)
    return params


def test_lora_classifier_bridge_layout(cls_params):
    params = tllama.params_from_tpudl(cls_params, dtype=torch.bfloat16,
                                      device="cpu")
    model = tllama.LlamaForSequenceClassification(
        tllama.LLAMA_TINY(**_CLS_CFG), device="meta")
    assert set(params) == set(model.state_dict())
    a = params["model.layer_1.attention.k_proj.lora_a"]
    want = cls_params["model"]["layer_1"]["attention"]["k_proj"]["lora_a"]
    assert a.dtype == torch.float32 and tuple(a.shape) == want.shape
    np.testing.assert_array_equal(a.numpy(), want)
    assert params["model.layer_0.up_proj.weight"].dtype == torch.bfloat16
    w = params["classifier.weight"]
    assert w.dtype == torch.float32 and tuple(w.shape) == (3, 128)
    np.testing.assert_array_equal(w.numpy(), cls_params["classifier"]["kernel"].T)
    assert params["classifier.bias"].dtype == torch.float32
    # Every leaf is accounted for, both ways.
    partial = {k: v for k, v in cls_params.items() if k != "classifier"}
    with pytest.raises(ValueError, match="lacks"):
        tllama.params_from_tpudl(partial, device="cpu")
    extra = dict(cls_params, moe={"router": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(ValueError, match="no counterpart"):
        tllama.params_from_tpudl(extra, device="cpu")


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_lora_classifier_forward_matches_tpudl(cls_params, attention_impl):
    """f32 logits of LlamaForSequenceClassification with adapters, on a
    right- and a left-padded batch (tpudl pools index sum(mask) - 1 in
    both; fused_ops="force" runs its Pallas kernels in interpret mode)."""
    jmodel = jllama.LlamaForSequenceClassification(jllama.LLAMA_TINY(
        dtype=jnp.float32, attention_impl=attention_impl, fused_ops="force",
        **_CLS_CFG))
    tmodel = tllama.LlamaForSequenceClassification(tllama.LLAMA_TINY(
        dtype=torch.float32, attention_impl=attention_impl, **_CLS_CFG),
        device="meta")
    tmodel.load_state_dict(tllama.params_from_tpudl(
        cls_params, dtype=torch.float32, device="cpu"), assign=True)
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 128, size=(3, 16)).astype(np.int32)
    right = np.ones_like(ids)
    right[1, 11:] = 0
    left = right[:, ::-1].copy()
    for mask in (right, left):
        want = jmodel.apply({"params": cls_params}, jnp.asarray(ids),
                            jnp.asarray(mask))
        with torch.no_grad():
            got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
        assert got.dtype == torch.float32 and got.shape == (3, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])


def test_padding_is_invisible_to_the_real_tokens(cls_params):
    """A sequence padded on the right or on the left gives, at its real
    tokens, the final hidden states of the sequence alone (positions skip
    padding, the kv mask hides it), on the flash path; so a right-padded
    row classifies as the sequence alone."""
    tmodel = tllama.LlamaForSequenceClassification(tllama.LLAMA_TINY(
        dtype=torch.float32, attention_impl="flash", **_CLS_CFG),
        device="meta")
    tmodel.load_state_dict(tllama.params_from_tpudl(
        cls_params, dtype=torch.float32, device="cpu"), assign=True)
    seq = torch.from_numpy(np.random.default_rng(7).integers(
        1, 128, size=(1, 10)))
    pad = torch.zeros(1, 6, dtype=seq.dtype)
    ones, zeros = torch.ones(1, 10, dtype=torch.int64), torch.zeros(1, 6, dtype=torch.int64)
    with torch.no_grad():
        alone, _ = tmodel.model(seq, torch.ones_like(seq))
        r, _ = tmodel.model(torch.cat([seq, pad], 1),
                            torch.cat([ones, zeros], 1))
        lft, _ = tmodel.model(torch.cat([pad, seq], 1),
                              torch.cat([zeros, ones], 1))
        torch.testing.assert_close(r[:, :10], alone, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lft[:, 6:], alone, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(
            tmodel(torch.cat([seq, pad], 1), torch.cat([ones, zeros], 1)),
            tmodel(seq), rtol=1e-4, atol=1e-5)


def test_build_model_parses_llama_names():
    from tpudl_torch.models.registry import build_model

    m = build_model("llama-tiny-lora", 2, device="meta",
                    attention_impl="flash")
    assert isinstance(m, tllama.LlamaForSequenceClassification)
    assert m.cfg.lora_rank == 16 and m.cfg.attention_impl == "flash"
    assert m.cfg.num_labels == 2 and m.cfg.dtype == torch.bfloat16
    assert build_model("llama-tiny", 3, device="meta").cfg.lora_rank == 0
    assert build_model("llama3-8b-lora", 2, device="meta",
                       lora_rank=8).cfg.lora_rank == 8
    moe = build_model("llama-tiny-lora-moe", 2, device="meta")
    assert moe.cfg.moe_experts == 8 and moe.cfg.lora_rank == 16
    with pytest.raises(ValueError, match="unknown llama size"):
        build_model("llama-huge", 2, device="meta")
    # Base frozen, adapters and the classifier trainable.
    frozen = {n for n, p in m.named_parameters() if not p.requires_grad}
    assert "model.layer_0.attention.q_proj.weight" in frozen
    assert "model.embed_tokens.weight" in frozen
    assert not any(n.endswith(("lora_a", "lora_b")) or
                   n.startswith("classifier") for n in frozen)


def test_merge_lora_matches_tpudl(cls_params):
    """merge_lora folds each adapter into its base weight as tpudl's does
    (kernel += A B * 16 / r): the merged state_dict is the tpudl merged
    tree's, and the rank-0 model on it computes the adapted model's
    logits."""
    from tpudl.models.lora import merge_lora as jmerge
    from tpudl_torch.models.lora import merge_lora

    params = tllama.params_from_tpudl(cls_params, dtype=torch.float32,
                                      device="cpu")
    merged = merge_lora(params)
    want = tllama.params_from_tpudl(jax.tree.map(np.asarray,
                                                 jmerge(cls_params)),
                                    dtype=torch.float32, device="cpu")
    assert set(merged) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(merged[name].numpy(), w.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    cfg = dict(_CLS_CFG, dtype=torch.float32)
    lora = tllama.LlamaForSequenceClassification(tllama.LLAMA_TINY(**cfg),
                                                 device="meta")
    lora.load_state_dict(params, assign=True)
    base = tllama.LlamaForSequenceClassification(
        tllama.LLAMA_TINY(**dict(cfg, lora_rank=0)), device="meta")
    base.load_state_dict(merged, assign=True)
    ids = torch.from_numpy(np.random.default_rng(8).integers(1, 128, (2, 12)))
    with torch.no_grad():
        torch.testing.assert_close(base(ids), lora(ids), rtol=1e-4, atol=1e-5)
