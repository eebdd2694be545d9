"""tpudl_torch.models (Llama decode path) against tpudl.models on the CPU.

tpudl's ``LlamaForCausalLM(LLAMA_TINY)`` params from ``model.init`` go
through ``params_from_tpudl`` into the port; the same left-padded
prompts then run through both packages' prefill and decode contracts.
Logits and the whole KV cache (k, v, valid, index) must agree: f32 at
rtol 1e-4 / atol 1e-5 (the BERT bridge's band, tests/test_bert.py:81),
bf16 at 5e-2. ``fused_ops`` True routes the port's norms and SwiGLU
through the kernel seam (the plain versions, on CPU tensors) and tpudl's
through its own ("auto": the composite off-TPU).
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
    ("lora_rank", 4), ("moe_experts", 8), ("weight_dtype", "int8"),
    ("fp8_train", True),
])
def test_unported_tiers_raise(field, value):
    cfg = tllama.LLAMA_TINY(**{field: value})
    with pytest.raises(NotImplementedError, match="not ported"):
        tllama.LlamaForCausalLM(cfg, device="meta")


def test_non_decode_forward_is_not_ported(jax_params):
    _, tmodel, tparams = _models(jax_params, "float32", True)
    tllama.bind_params(tmodel, tparams)
    with pytest.raises(NotImplementedError, match="non-decode"):
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
