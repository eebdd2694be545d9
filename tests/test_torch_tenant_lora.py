"""Multi-tenant LoRA serving over the paged KV cache: tpudl_torch against
tpudl on the CPU.

The same tiny f32 Llama (tpudl's ``model.init`` params through
``params_from_tpudl``) and the same adapters (tpudl's LoRA init, lora_b
drawn nonzero with numpy, in tpudl's flat form) serve the same requests
through tpudl's ``ServeSession.from_model(paged=True)`` /
``(adapters=...)`` and the port's, whose segmented LoRA runs its plain
version on CPU tensors: the greedy tokens must be identical. The port is
also held to tpudl's own contracts (tests/test_tenant_lora.py): the
AdapterPool lifecycle (validation, LRU eviction, lease safety, reload,
byte accounting), ``assert_tenant_parity`` exact for f32 pages and under
the margin for int8 pages, admission errors and the refusals of the
tiers not ported; and the paged primitives and cache against
tpudl.models.paged and tpudl.serve.cache.PagedKVCache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import llama as jllama
from tpudl.models.lora import extract_adapters as jextract
from tpudl.serve import Request as JRequest
from tpudl.serve import ServeSession as JSession
from tpudl_torch.models import paged
from tpudl_torch.models.generate import generate
from tpudl_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_tpudl
from tpudl_torch.models.lora import (
    as_flat_adapters,
    extract_adapters,
    merge_adapter,
    strip_adapters,
)
from tpudl_torch.obs import registry
from tpudl_torch.serve import (
    AdapterPool,
    PagedKVCache,
    Request,
    ServeSession,
    assert_tenant_parity,
)

#: tpudl's TINY of tests/test_tenant_lora.py.
TINY = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
            num_kv_heads=1, intermediate_size=64, max_seq_len=64,
            rope_theta=10_000.0)
PROMPT_LEN = 8


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def base():
    """(tpudl model, tpudl params, port model, port params), f32."""
    jmodel = jllama.LlamaForCausalLM(jllama.LlamaConfig(**TINY,
                                                        dtype=jnp.float32))
    jparams = jmodel.init(jax.random.key(0),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    model = LlamaForCausalLM(LlamaConfig(**TINY, dtype=torch.float32),
                             device="meta")
    params = params_from_tpudl(jax.tree.map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, params


def make_adapter(seed, rank=2, b_scale=0.05, sizes=TINY):
    """tpudl's make_adapter: tpudl's LoRA init for lora_a, lora_b drawn
    with numpy; tpudl's flat form ('/'-joined paths, numpy arrays)."""
    cfg = jllama.LlamaConfig(**sizes, dtype=jnp.float32, lora_rank=rank)
    lp = jllama.LlamaForCausalLM(cfg).init(
        jax.random.key(seed), jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return {path: {"lora_a": np.asarray(f["lora_a"]),
                   "lora_b": rng.normal(scale=b_scale, size=np.shape(
                       f["lora_b"])).astype(np.float32)}
            for path, f in jextract(lp).items()}


@pytest.fixture(scope="module")
def adapters():
    # Ragged ranks: "t2" is rank 1 under r_max 2 (the zero-page contract).
    return {"t0": make_adapter(1), "t1": make_adapter(2),
            "t2": make_adapter(3, rank=1)}


def tenant_requests(cls, tenants, n=6, seed=0, max_new=(4, 10)):
    rng = np.random.default_rng(seed)
    cycle = [None] + list(tenants)
    return [cls(request_id=f"r{seed}-{i}",
                input_ids=rng.integers(1, 100, size=int(
                    rng.integers(2, PROMPT_LEN + 1))).tolist(),
                max_new_tokens=int(rng.integers(*max_new)),
                tenant=cycle[i % len(cycle)])
            for i in range(n)]


def _tokens(results):
    return {rid: (list(r.tokens), r.finish_reason) for rid, r in results.items()}


# ---------------------------------------------------------------------------
# whole sessions against tpudl's
# ---------------------------------------------------------------------------


def test_multi_tenant_session_matches_tpudl(one_thread):
    """LLAMA_TINY in f32, mixed tenants and tenantless slots, ragged
    ranks, a pool that must evict and reload: the port's tokens, finish
    reasons, pool statistics and schedule are tpudl's."""
    from tpudl.models.llama import LLAMA_TINY as J_TINY
    from tpudl_torch.models.llama import LLAMA_TINY

    sizes = dict(max_seq_len=64)
    jmodel = jllama.LlamaForCausalLM(J_TINY(dtype=jnp.float32, **sizes))
    jparams = jmodel.init(jax.random.key(0),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    model = LlamaForCausalLM(LLAMA_TINY(dtype=torch.float32, **sizes),
                             device="meta")
    params = params_from_tpudl(jax.tree.map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    tiny = {k: getattr(model.cfg, k) for k in TINY}
    adapters = {"t0": make_adapter(1, sizes=tiny),
                "t1": make_adapter(2, sizes=tiny),
                "t2": make_adapter(3, rank=1, sizes=tiny)}
    kw = dict(prompt_len=PROMPT_LEN, num_slots=3, adapters=adapters,
              adapter_pages=5, page_size=4)
    js = JSession.from_model(jmodel, jparams, **kw)
    want = js.serve(tenant_requests(JRequest, adapters, n=9, seed=4))
    ts = ServeSession.from_model(model, params, **kw)
    got = ts.serve(tenant_requests(Request, adapters, n=9, seed=4))
    assert _tokens(got) == _tokens(want)
    jstats, stats = js.engine.adapter_pool.stats(), ts.engine.adapter_pool.stats()
    assert stats == jstats and stats["evictions"] > 0 and stats["reloads"] > 0
    assert (ts.engine.num_prefills, ts.engine.num_decode_steps) == (
        js.engine.num_prefills, js.engine.num_decode_steps)


def test_paged_session_matches_tpudl_and_the_dense_cache(base, one_thread):
    """A paged decode with a pool smaller than capacity parity (so seating
    waits for pages): tpudl's paged tokens, and the port's dense ones."""
    jmodel, jparams, model, params = base
    rng = np.random.default_rng(7)

    def requests(cls):
        return [cls(f"p{i}", rng.integers(1, 100, size=int(
            rng.integers(2, PROMPT_LEN + 1))).tolist(),
            max_new_tokens=int(rng.integers(4, 20))) for i in range(6)]

    state = rng.bit_generator.state
    kw = dict(prompt_len=PROMPT_LEN, num_slots=3, paged=True, page_size=4,
              num_pages=20)
    js = JSession.from_model(jmodel, jparams, **kw)
    want = js.serve(requests(JRequest))
    rng.bit_generator.state = state
    ts = ServeSession.from_model(model, params, **kw)
    got = ts.serve(requests(Request))
    assert _tokens(got) == _tokens(want)
    assert ts.engine.num_rollovers == 0
    rng.bit_generator.state = state
    dense = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                    num_slots=3).serve(requests(Request))
    assert _tokens(dense) == _tokens(got)


# ---------------------------------------------------------------------------
# the parity gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_multi_tenant_parity_exact_f32(base, adapters, impl, one_thread):
    _, _, model, params = base
    session = ServeSession.from_model(
        model, params, prompt_len=PROMPT_LEN, num_slots=4, adapters=adapters,
        adapter_impl=impl)
    assert_tenant_parity(session, model, params, adapters,
                         tenant_requests(Request, adapters, n=7, seed=0))


def test_multi_tenant_parity_int8_pages_margin(base, adapters, one_thread):
    """int8 pages: a greedy flip must be a near-tie under the
    teacher-forced margin (tpudl's alpha 4, atol 0.1)."""
    _, _, model, params = base
    session = ServeSession.from_model(
        model, params, prompt_len=PROMPT_LEN, num_slots=4, adapters=adapters,
        adapter_dtype="int8", adapter_alpha=4.0)
    assert session.engine.adapter_pool.quantized
    assert_tenant_parity(session, model, params, adapters,
                         tenant_requests(Request, adapters, n=6, seed=1),
                         atol=0.1, alpha=4.0)


def test_evicted_tenant_reloads_transparently(base, adapters, one_thread):
    _, _, model, params = base
    session = ServeSession.from_model(
        model, params, prompt_len=PROMPT_LEN, num_slots=2,
        adapters={"t0": adapters["t0"], "t1": adapters["t1"]},
        adapter_pages=3)
    reloads0 = registry().counter("serve_adapter_reloads_total").value
    out0 = session.serve([Request("a", [3, 4, 5], 4, tenant="t0")])
    out1 = session.serve([Request("b", [3, 4, 5], 4, tenant="t1")])
    out2 = session.serve([Request("c", [3, 4, 5], 4, tenant="t0")])
    assert out0["a"].ok and out1["b"].ok and out2["c"].ok
    assert out2["c"].tokens == out0["a"].tokens
    stats = session.engine.adapter_pool.stats()
    assert stats["evictions"] >= 1 and stats["reloads"] >= 1
    assert registry().counter("serve_adapter_reloads_total").value > reloads0
    merged = merge_adapter(params, adapters["t0"])
    want = generate(model, merged, torch.tensor([[3, 4, 5]]),
                    max_new_tokens=4)[0].tolist()
    assert out2["c"].tokens == want


# ---------------------------------------------------------------------------
# AdapterPool lifecycle
# ---------------------------------------------------------------------------


def test_adapter_pool_register_validates(base):
    _, _, model, _ = base
    pool = AdapterPool(model.cfg, r_max=2, num_slots=2, num_pages=9,
                       device="cpu")
    with pytest.raises(ValueError, match="no lora_a"):
        pool.register("empty", {})
    bad = {"model/layer_0/attention/q_proj": {
        "lora_a": np.zeros((7, 2), np.float32),
        "lora_b": np.zeros((2, 32), np.float32)}}
    with pytest.raises(ValueError, match="do not fit site"):
        pool.register("bad", bad)
    with pytest.raises(ValueError, match="outside"):
        pool.register("big", make_adapter(9, rank=4))
    with pytest.raises(ValueError, match="not an adaptable site"):
        pool.register("alien", {"model/layer_0/lm_head": {
            "lora_a": np.zeros((32, 2), np.float32),
            "lora_b": np.zeros((2, 32), np.float32)}})
    with pytest.raises(ValueError, match="cannot hold one rank-2"):
        AdapterPool(model.cfg, r_max=2, num_slots=2, num_pages=2,
                    device="cpu")
    with pytest.raises(ValueError, match="int8"):
        AdapterPool(model.cfg, r_max=2, num_slots=2, dtype="fp8",
                    device="cpu")


def test_adapter_pool_lru_eviction_and_lease_safety(base, adapters):
    """tpudl's scenario: refcount-0 residents evict LRU-first under
    pressure; a leased adapter is never evicted."""
    _, _, model, _ = base
    pool = AdapterPool(model.cfg, r_max=2, num_slots=2, num_pages=5,
                       device="cpu")
    for tid, tree in adapters.items():
        pool.register(tid, tree)
    row0, _ = pool.acquire("t0")
    assert set(row0[row0 != 0]) and pool.resident_since("t0") is not None
    pool.release("t0")
    pool.acquire("t1")
    pool.release("t1")
    assert pool.stats()["resident"] == 2 and pool.free_pages == 0
    pool.acquire("t2")
    assert pool.stats()["evictions"] == 1
    assert pool.resident_since("t0") is None
    assert pool.resident_since("t1") is not None
    pool.release("t2")
    pool.acquire("t1")
    pool.acquire("t2")
    assert not pool.can_seat("t0") and pool.can_ever_seat("t0")
    with pytest.raises(RuntimeError, match="leased"):
        pool.acquire("t0")
    pool.release("t1")
    pool.release("t2")
    pool.acquire("t0")
    assert pool.stats()["reloads"] >= 1
    pool.release("t0")


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_adapter_pool_nbytes_reconciles_with_buffers(base, dtype):
    _, _, model, _ = base
    pool = AdapterPool(model.cfg, r_max=2, num_slots=4, num_pages=9,
                       dtype=dtype, device="cpu")
    leaves = [t for sites in pool.pools.values() for e in sites.values()
              for t in e.values()]
    device = sum(t.numel() * t.element_size() for t in leaves)
    assert pool.nbytes == device + pool.slot_table.nbytes + pool.slot_scale.nbytes
    assert pool.bytes_per_page * pool.num_pages == device
    scales = [k for sites in pool.pools.values() for e in sites.values()
              for k in e if k.endswith("_scale")]
    assert bool(scales) == (dtype == "int8")
    assert pool.adapters_per_gb(2) == 1e9 / (pool.bytes_per_page * 2)


def test_pages_hold_tpudls_rows(base, adapters):
    """A loaded page holds tpudl's rows: A[:, j] and B[j, :] (int8: the
    quantized rows and their scales, bit for bit)."""
    from tpudl.serve import AdapterPool as JPool

    jmodel, _, model, _ = base
    for dtype in (None, "int8"):
        jpool = JPool(jmodel.cfg, r_max=2, num_slots=2, num_pages=9,
                      dtype=dtype)
        pool = AdapterPool(model.cfg, r_max=2, num_slots=2, num_pages=9,
                           dtype=dtype, device="cpu")
        for p in (jpool, pool):
            p.register("t", adapters["t1"])
        assert list(jpool.acquire("t")[0]) == list(pool.acquire("t")[0])
        for layer, sites in pool.pools.items():
            for site, entry in sites.items():
                for key, t in entry.items():
                    np.testing.assert_array_equal(
                        t.numpy(), np.asarray(jpool.pools[layer][site][key]),
                        err_msg=f"{layer}/{site}/{key}")


def test_reregister_swaps_factors_and_refuses_leased(base, adapters):
    _, _, model, _ = base
    pool = AdapterPool(model.cfg, r_max=2, num_slots=2, num_pages=9,
                       device="cpu")
    pool.register("t", adapters["t0"])
    pool.acquire("t")
    pool.release("t")
    pool.register("t", adapters["t1"])
    assert pool.resident_since("t") is None
    row, _ = pool.acquire("t")
    np.testing.assert_array_equal(
        pool.pools["layer_0"]["q_proj"]["a"][int(row[0])].numpy(),
        adapters["t1"]["model/layer_0/attention/q_proj"]["lora_a"][:, 0])
    with pytest.raises(ValueError, match="leased"):
        pool.register("t", adapters["t0"])
    pool.release("t")
    pool.register("t", adapters["t0"])


def test_seat_failure_releases_adapter_pin(base, adapters):
    _, _, model, params = base
    session = ServeSession.from_model(
        model, params, prompt_len=PROMPT_LEN, num_slots=2,
        adapters={"t0": adapters["t0"]})
    engine = session.engine
    pool = engine.adapter_pool
    orig = engine.cache.seat

    def boom(*args, **kwargs):
        raise RuntimeError("injected seat failure")

    engine.cache.seat = boom
    session.submit(Request("x", [1, 2, 3], max_new_tokens=4, tenant="t0"))
    with pytest.raises(RuntimeError, match="injected seat failure"):
        engine.step()
    engine.cache.seat = orig
    assert pool.stats()["leased"] == 0
    pool.acquire("t0")
    pool.release("t0")


# ---------------------------------------------------------------------------
# the adapter helpers, admission and refusals
# ---------------------------------------------------------------------------


def test_adapter_helpers_roundtrip(base):
    """strip/extract/merge agree with LoRALinear's own math on a LoRA
    state_dict."""
    _, _, model, _ = base
    lmodel = LlamaForCausalLM(LlamaConfig(**TINY, dtype=torch.float32,
                                          lora_rank=2), device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in lmodel.named_parameters():
            p.normal_(0.0, 0.05, generator=g)
    lp = {k: v.detach() for k, v in lmodel.state_dict().items()}
    flat = extract_adapters(lp)
    assert len(flat) == 7 and as_flat_adapters(lp).keys() == flat.keys()
    assert as_flat_adapters(flat) == flat
    base_sd = strip_adapters(lp)
    assert not extract_adapters(base_sd)
    merged = merge_adapter(base_sd, flat, alpha=16.0)
    ids = torch.tensor([[5, 6, 7]])
    from tpudl_torch.models.llama import bind_params

    bind_params(model, merged)
    with torch.no_grad():
        got = model(ids)[0]
        want = lmodel(ids)[0]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_tenant_admission_validation_and_refusals(base, adapters,
                                                  monkeypatch):
    _, _, model, params = base
    one = {"t0": adapters["t0"]}
    session = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                      num_slots=2, adapters=one)
    assert session.engine.paged
    with pytest.raises(ValueError, match="unknown tenant"):
        session.submit(Request("x", [1, 2], 2, tenant="nobody"))
    plain = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                    num_slots=2, paged=True)
    with pytest.raises(ValueError, match="serves no adapters"):
        plain.submit(Request("y", [1, 2], 2, tenant="t0"))
    kw = dict(prompt_len=PROMPT_LEN, num_slots=2)
    with pytest.raises(ValueError, match="prefix_share"):
        ServeSession.from_model(model, params, adapters=one,
                                prefix_share=True, **kw)
    with pytest.raises(ValueError, match="spec_k"):
        ServeSession.from_model(model, params, adapters=one, spec_k=2, **kw)
    with pytest.raises(ValueError, match="registers no tenants"):
        ServeSession.from_model(model, params, adapters={}, **kw)
    with pytest.raises(ValueError, match="require paged"):
        ServeSession.from_model(model, params, page_size=4, **kw)
    for arg, value in (("prefix_share", True), ("spec_k", 2)):
        with pytest.raises(NotImplementedError, match="item 3"):
            ServeSession.from_model(model, params, paged=True,
                                    **{arg: value}, **kw)
    # int8 KV pages and quantized weights are ported
    # (tests/test_torch_quant.py); they compose with adapters.
    monkeypatch.setenv("TPUDL_SERVE_KV_DTYPE", "int8")
    session = ServeSession.from_model(model, params, adapters=one,
                                      weight_dtype="int8", **kw)
    assert session.engine.cache.quantized
    assert session.serve([Request("z", [1, 2, 3], 3, tenant="t0")])["z"].ok
    with pytest.raises(ValueError, match="require paged"):
        ServeSession.from_model(model, params, **kw)
    monkeypatch.delenv("TPUDL_SERVE_KV_DTYPE")
    monkeypatch.setenv("TPUDL_SERVE_LORA_DTYPE", "int8")
    monkeypatch.setenv("TPUDL_SERVE_LORA_PAGES", "7")
    pool = ServeSession.from_model(model, params, adapters=one,
                                   **kw).engine.adapter_pool
    assert pool.quantized and pool.num_pages == 7 and pool.r_max == 2


# ---------------------------------------------------------------------------
# the paged primitives and the cache
# ---------------------------------------------------------------------------


def test_paged_primitives_match_tpudl():
    from tpudl.models import paged as jpaged

    rng = np.random.default_rng(11)
    pages = rng.normal(size=(7, 4, 2, 3)).astype(np.float32)
    table = np.array([[1, 5, 0], [2, 3, 6], [0, 0, 0]], np.int32)
    start = np.array([1, 0, 0], np.int32)
    lens = np.array([5, 9, 0], np.int32)
    value = rng.normal(size=(3, 2, 2, 3)).astype(np.float32)
    jview = jpaged.PagedView(jnp.asarray(table), jnp.asarray(start),
                             jnp.asarray(lens), 4, False)
    view = paged.PagedView(*(torch.from_numpy(a).long()
                             for a in (table, start, lens)), 4)
    jw, _ = jpaged.paged_write(jnp.asarray(pages), None, jnp.asarray(value),
                               jview)
    got, _ = paged.paged_write(torch.from_numpy(pages.copy()), None,
                               torch.from_numpy(value), view)
    # Page 0 is the trash page: idle slots' writes land there in any order.
    np.testing.assert_array_equal(got[1:].numpy(), np.asarray(jw)[1:])
    np.testing.assert_array_equal(
        paged.paged_gather(got, None, view, torch.float32)[:2].numpy(),
        np.asarray(jpaged.paged_gather(jw, None, jview, jnp.float32))[:2])
    np.testing.assert_array_equal(
        paged.paged_attend_mask(view, chunk=2).numpy(),
        np.asarray(jpaged.paged_attend_mask(jview, chunk=2)))
    np.testing.assert_array_equal(
        paged.flat_page_row_index(torch.from_numpy(table).long(), 4).numpy(),
        np.asarray(jpaged.flat_page_row_index(jnp.asarray(table), 4)))


def test_paged_cache_bookkeeping_and_refusals(base):
    from tpudl_torch.models.llama import init_cache
    from tpudl_torch.serve.cache import RadixPrefixTree

    _, _, model, _ = base
    template = init_cache(model.cfg, 3, device="meta")
    cache = PagedKVCache(template, page_size=16, num_pages=9, device="cpu")
    assert (cache.num_slots, cache.pages_per_slot, cache.max_seq_len) == (
        3, 4, 64)
    assert cache.free_pages == cache.available_pages == 8
    assert cache.fits_tokens(64) and cache.fits_request([1], 64)
    row = {"model": {"layer_0": {"attention": {
        "k": torch.arange(64 * 16, dtype=torch.float32).reshape(1, 64, 1, 16),
        "v": -torch.ones(1, 64, 1, 16)}}}}
    cache.seat(row, 1, pad=3, prompt_len=8, reserve_tokens=40)
    assert cache.free_pages == 5 and cache.lens[1] == 8 and cache.start[1] == 3
    page = cache.page_table[1, 0]
    pool = cache.cache["model"]["layer_0"]["attention"]
    torch.testing.assert_close(pool["pages_k"][page], row["model"]["layer_0"][
        "attention"]["k"][0, :16])
    with pytest.raises(ValueError, match="already seated"):
        cache.seat(row, 1, 0, 8, 8)
    cache.seat(row, 0, 0, 8, 64)  # 4 of the 5 free pages
    with pytest.raises(RuntimeError, match="exhausted"):
        cache.seat(row, 2, 0, 8, 32)
    cache.free(0)
    cache.advance([1], 2)
    assert cache.lens[1] == 10
    table, start, lens = cache.dispatch_args()
    assert table.dtype == np.int32 and lens[1] == 10
    cache.free(1)
    assert cache.free_pages == 8 and not cache.page_table[1].any()
    want = sum(t.numel() * 4 for layer in cache.cache["model"].values()
               for t in layer["attention"].values())
    assert cache.nbytes == want + 3 * 4 * 4 + 3 * 4 + 3 * 4
    for call in (cache.seat_shared, cache.gather_prefix_rows,
                 cache.match_and_lease, cache.export_request,
                 cache.import_request, RadixPrefixTree):
        with pytest.raises(NotImplementedError, match="item 3"):
            call()
    with pytest.raises(NotImplementedError, match="item 3"):
        PagedKVCache(template, prefix_share=True)
    with pytest.raises(ValueError, match="kv_dtype must be"):
        PagedKVCache(template, kv_dtype="int4")
    with pytest.raises(ValueError, match="cannot hold even one slot"):
        PagedKVCache(template, page_size=16, num_pages=4)
