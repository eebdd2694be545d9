"""The radix prefix cache and speculative decoding: tpudl_torch against
tpudl on the CPU.

The same tiny f32 Llama (tpudl's ``model.init`` params through
``params_from_tpudl``; LLAMA_TINY at max_seq_len 96, prompt window 16,
page 4, as tests/test_prefix_spec.py sets them) and the same requests
(numpy seeds) go through tpudl's and the port's ``ServeSession.from_model(
paged=True, prefix_share=True)`` / ``(spec_k=K)`` / both: the greedy
tokens must be identical, and identical to ``generate()``. Below that:
the radix tree driven by the same operations in both packages (leases,
copy-on-write splits, LRU eviction, hash collisions) gives the same
answers and ``stats()``; the paged cache's radix tier (left-aligned
seating, the prefix-row gather, admission) holds the same pages and
bytes; the two chunk contracts (``chunk_prefill_fn``,
``paged_chunk_decode_fn``) give tpudl's logits and cache rows at 1e-5;
the acceptance rules give bit-equal outputs on the same host inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import llama as jllama
from tpudl.models.generate import chunk_prefill_fn as jchunk_prefill_fn
from tpudl.models.generate import paged_chunk_decode_fn as jpaged_chunk_fn
from tpudl.models.generate import prefill_fn as jprefill_fn
from tpudl.quant import quantize_model as jquantize_model
from tpudl.serve import PagedKVCache as JPagedKVCache
from tpudl.serve import RadixPrefixTree as JRadixPrefixTree
from tpudl.serve import Request as JRequest
from tpudl.serve import ServeSession as JSession
from tpudl.serve import speculate as jspec
from tpudl_torch.models.generate import (
    chunk_prefill_fn,
    generate,
    paged_chunk_decode_fn,
    prefill_fn,
)
from tpudl_torch.models.llama import (
    LLAMA_TINY,
    LlamaForCausalLM,
    init_cache,
    params_from_tpudl,
)
from tpudl_torch.obs import registry
from tpudl_torch.serve import (
    PagedKVCache,
    RadixPrefixTree,
    Request,
    ServeSession,
    speculate,
)

PROMPT_LEN = 16
PAGE = 4
TOL = 1e-5


def _port_model(cfg_kw=None):
    return LlamaForCausalLM(LLAMA_TINY(dtype=torch.float32, max_seq_len=96,
                                       **(cfg_kw or {})), device="meta")


def _port_params(jparams):
    return params_from_tpudl(jax.tree.map(np.asarray, jparams),
                             dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def models():
    """(tpudl model, tpudl params, port model, port params), f32, and the
    unrelated "garbage" draft's params in both packages."""
    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(dtype=jnp.float32,
                                                       max_seq_len=96))
    ids = jnp.zeros((1, PROMPT_LEN), jnp.int32)
    init = jax.jit(jmodel.init)
    jparams = init(jax.random.key(0), ids)["params"]
    jgarbage = init(jax.random.key(123), ids)["params"]
    return dict(jmodel=jmodel, jparams=jparams, model=_port_model(),
                params=_port_params(jparams), jgarbage=jgarbage,
                garbage=_port_params(jgarbage),
                jprefill=jax.jit(jprefill_fn(jmodel)))


def _sessions(models, **kw):
    """The same session in both packages (tpudl's, the port's)."""
    kw = dict(prompt_len=PROMPT_LEN, num_slots=2, paged=True, page_size=PAGE,
              **kw)
    jkw, tkw = dict(kw), dict(kw)
    if "draft" in kw:
        del jkw["draft"], tkw["draft"]
        jkw.update(draft_model=models["jmodel"],
                   draft_params=models["jgarbage"])
        tkw.update(draft_model=models["model"], draft_params=models["garbage"])
    return (JSession.from_model(models["jmodel"], models["jparams"], **jkw),
            ServeSession.from_model(models["model"], models["params"], **tkw))


def _serve_both(models, requests, **kw):
    """Serve ``requests`` through both packages' sessions; the port's
    session and both token dicts."""
    jsession, session = _sessions(models, **kw)
    jres = jsession.serve([JRequest(**dataclasses.asdict(r))
                           for r in requests])
    res = session.serve([dataclasses.replace(r) for r in requests])
    return session, jres, res


def _same_tokens(requests, jres, res):
    for req in requests:
        assert res[req.request_id].ok, res[req.request_id]
        assert res[req.request_id].tokens == jres[req.request_id].tokens, (
            req.request_id)
        assert (res[req.request_id].finish_reason
                == jres[req.request_id].finish_reason)


def _generate(models, req):
    return generate(models["model"], models["params"],
                    torch.as_tensor(req.input_ids)[None, :],
                    max_new_tokens=req.max_new_tokens)[0].numpy()


def _shared_requests(n, shared_tokens=12, seed=0, max_new=8, tag="r"):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 512, size=shared_tokens).tolist()
    return [Request(f"{tag}{i}", shared + rng.integers(
        1, 512, size=int(rng.integers(1, PROMPT_LEN - shared_tokens + 1))
    ).tolist(), max_new_tokens=max_new) for i in range(n)]


# ---------------------------------------------------------------------------
# the radix tree: the same operations in both packages
# ---------------------------------------------------------------------------


def _tree_insert_and_match(tree, out):
    ids = list(range(100, 116))
    out.append(tree.match_len(ids))
    node = tree.insert_suffix(None, tree.blocks_of(ids), [5, 6, 7, 8])
    out += [tree.match_len(ids), tree.match_len(ids[:9]),
            tree.match_len([1, 2, 3]), tree.match_info(ids), tree.stats()]
    tree.release(node)
    out += [tree.match_info(ids), tree.stats()]


def _tree_cow_split(tree, out):
    ab = list(range(100, 116))
    tree.release(tree.insert_suffix(None, tree.blocks_of(ab), [5, 6, 7, 8]))
    ac = ab[:8] + [7] * 8
    pages, deepest = tree.match_and_lease(ac)
    out += [pages, tree.stats(), tree.evictable_pages]
    new = tree.insert_suffix(deepest, tree.blocks_of(ac)[2:], [10, 11])
    out += [tree.match_len(ab), tree.match_len(ac), tree.match_info(ab)]
    tree.release(new)
    out += [tree.stats(), tree.evictable_pages, tree.cached_pages]


def _tree_split_refcount(tree, out):
    ab = list(range(100, 116))
    lease_ab = tree.insert_suffix(None, tree.blocks_of(ab), [5, 6, 7, 8])
    pages, lease_ac = tree.match_and_lease(ab[:8] + [9] * 8)
    out += [pages, tree.evictable_pages]
    tree.release(lease_ac)
    out.append(tree.evictable_pages)
    tree.release(lease_ab)
    out += [tree.evictable_pages, tree.stats()]


def _tree_lru_eviction(tree, out):
    a = tree.insert_suffix(None, tree.blocks_of([1] * 8), [2, 3])
    b = tree.insert_suffix(None, tree.blocks_of([2] * 8), [4, 9])
    tree.release(a)
    tree.release(b)
    _, lease = tree.match_and_lease([1] * 8)
    tree.release(lease)
    out += [sorted(tree.evict(2)), tree.match_len([2] * 8),
            tree.match_len([1] * 8)]
    pages, lease = tree.match_and_lease([1] * 8)
    out += [pages, tree.evict(10), tree.stats()]
    tree.release(lease)
    out += [tree.evict(10), tree.stats()]


def _tree_collisions(tree, out):
    n1 = tree.insert_suffix(None, tree.blocks_of([1] * 8), [2, 3])
    n2 = tree.insert_suffix(None, tree.blocks_of([9] * 8), [4, 5])
    out += [tree.match_len([1] * 8), tree.match_len([9] * 8),
            tree.match_len([3] * 8)]
    pages, lease = tree.match_and_lease([9] * 8)
    out.append(pages)
    tree.release(lease)
    tree.release(n1)
    tree.release(n2)
    out += [sorted(tree.evict(10)), tree.stats()]


def _tree_random(tree, out):
    """A long seeded mix: prompts over three shared prefixes, seats
    (match, lease, insert the unmatched full blocks on fresh pages),
    releases in random order and evictions of random size."""
    rng = np.random.default_rng(3)
    prefixes = [rng.integers(1, 50, size=12).tolist() for _ in range(3)]
    leases, next_page = [], 1
    for _ in range(60):
        op = rng.integers(0, 4)
        if op <= 1:
            ids = prefixes[rng.integers(0, 3)][: int(rng.integers(0, 13))] + \
                rng.integers(1, 50, size=int(rng.integers(0, 9))).tolist()
            pages, deepest = tree.match_and_lease(ids)
            fresh = tree.blocks_of(ids)[len(pages):]
            node = tree.insert_suffix(
                deepest, fresh, list(range(next_page, next_page + len(fresh))))
            next_page += len(fresh)
            final = node if node is not None else deepest
            if final is not None:
                leases.append(final)
            out += [pages, tree.match_info(ids)]
        elif op == 2 and leases:
            tree.release(leases.pop(int(rng.integers(0, len(leases)))))
        else:
            out.append(tree.evict(int(rng.integers(1, 6))))
        out.append(tree.stats())


@pytest.mark.parametrize("scenario", [
    _tree_insert_and_match, _tree_cow_split, _tree_split_refcount,
    _tree_lru_eviction, _tree_collisions, _tree_random],
    ids=lambda f: f.__name__[6:])
def test_radix_tree_matches_tpudl(scenario, monkeypatch):
    """Match lengths, leased pages, evicted page ids and ``stats()`` after
    every step are tpudl's. The collision case forces every block hash
    to one value in both packages: matching must resolve by the full
    token-block compare."""
    import tpudl.serve.cache as jcache_mod
    import tpudl_torch.serve.cache as cache_mod

    if scenario is _tree_collisions:
        monkeypatch.setattr(jcache_mod, "block_hash", lambda block: 7)
        monkeypatch.setattr(cache_mod, "block_hash", lambda block: 7)
    want, got = [], []
    scenario(JRadixPrefixTree(PAGE), want)
    scenario(RadixPrefixTree(PAGE), got)
    assert got == want


# ---------------------------------------------------------------------------
# the paged cache's radix tier against tpudl's
# ---------------------------------------------------------------------------


def _templates(num_slots=2, seq=32, hkv=2, hd=4):
    jt = {"layers_0": {"attn": {
        "k": jax.ShapeDtypeStruct((num_slots, seq, hkv, hd), jnp.float32),
        "v": jax.ShapeDtypeStruct((num_slots, seq, hkv, hd), jnp.float32),
        "valid": jax.ShapeDtypeStruct((num_slots, seq), jnp.bool_),
        "index": jax.ShapeDtypeStruct((), jnp.int32)}}}
    t = {"layers_0": {"attn": {
        "k": torch.empty((num_slots, seq, hkv, hd), device="meta"),
        "v": torch.empty((num_slots, seq, hkv, hd), device="meta"),
        "valid": torch.empty((num_slots, seq), dtype=torch.bool,
                             device="meta"),
        "index": 0}}}
    return jt, t


def _rows(seq=32, hkv=2, hd=4, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(1, seq, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(1, seq, hkv, hd)).astype(np.float32)
    jrow = {"layers_0": {"attn": {
        "k": jnp.asarray(k), "v": jnp.asarray(v),
        "valid": jnp.ones((1, seq), jnp.bool_), "index": jnp.int32(8)}}}
    row = {"layers_0": {"attn": {
        "k": torch.from_numpy(k), "v": torch.from_numpy(v),
        "valid": torch.ones((1, seq), dtype=torch.bool), "index": 8}}}
    return jrow, row


def _caches(kv_dtype=None, **kw):
    jt, t = _templates()
    return (JPagedKVCache(jt, page_size=PAGE, kv_dtype=kv_dtype,
                          prefix_share=True, **kw),
            PagedKVCache(t, page_size=PAGE, kv_dtype=kv_dtype,
                         prefix_share=True, device="cpu", **kw))


def _same_state(jc, c):
    """Addressing, free pool, tree and every used page's bytes."""
    np.testing.assert_array_equal(c.page_table, jc.page_table)
    np.testing.assert_array_equal(c.start, jc.start)
    np.testing.assert_array_equal(c.lens, jc.lens)
    assert (c.free_pages, c.available_pages, c.radix.stats()) == (
        jc.free_pages, jc.available_pages, jc.radix.stats())
    used = np.unique(c.page_table[c.page_table > 0])
    jpool, pool = jc.cache["layers_0"]["attn"], c.cache["layers_0"]["attn"]
    for name in pool:
        # int8 pools: XLA's f32 division may part from torch's by one ulp
        # in a scale, which can move a value across a rounding boundary.
        got, want = pool[name].numpy()[used], np.asarray(jpool[name])[used]
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=TOL,
                                   atol=1 if got.dtype == np.int8 else TOL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_seat_shared_and_gather_match_tpudl(kv_dtype):
    """Left-aligned seating maps matched pages copy-on-write and scatters
    only the unshared pages, from a full-prefill row (row_offset = pad)
    and from a chunk row (0); the prefix-row gather gives tpudl's rows;
    free keeps the tree's pages cached; the pad-aligned seat refuses."""
    jc, c = _caches(kv_dtype)
    ids = list(range(100, 110))  # 10 tokens: 2 full blocks + a tail
    (jrow, row), (jrow2, row2) = _rows(), _rows(seed=1)
    for cache, r in ((jc, jrow), (c, row)):
        cache.seat_shared(r, 0, ids, reserve_tokens=16,
                          lease=cache.match_and_lease(ids), row_offset=3)
    _same_state(jc, c)
    ids2 = ids[:8] + [7, 7, 7]
    for cache, r in ((jc, jrow2), (c, row2)):
        lease = cache.match_and_lease(ids2)
        assert len(lease[0]) == 2
        cache.seat_shared(r, 1, ids2, reserve_tokens=15, lease=lease)
    _same_state(jc, c)
    assert list(c.page_table[0][:2]) == list(c.page_table[1][:2])
    assert (c.start[1], c.lens[1]) == (0, 11)
    for n_tok in (8, 7):
        jpages, jlease = jc.match_and_lease(ids2)
        pages, lease = c.match_and_lease(ids2)
        want = jc.gather_prefix_rows(jpages, n_tok)["layers_0"]["attn"]
        got = c.gather_prefix_rows(pages, n_tok)["layers_0"]["attn"]
        # Rows past the prefix come from the trash page (masked).
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key].numpy()[:, :n_tok],
                                       np.asarray(want[key])[:, :n_tok],
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(want["valid"]))
        assert int(got["index"]) == int(want["index"]) == n_tok
        jc.release_lease(jlease)
        c.release_lease(lease)
    for cache in (jc, c):
        cache.free(0)
        cache.free(1)
    _same_state(jc, c)
    assert c.radix.evictable_pages == 2
    assert c.available_pages == c.num_pages - 1
    with pytest.raises(ValueError, match="seat_shared"):
        c.seat(row, 0, pad=2, prompt_len=8, reserve_tokens=8)
    for cache in (jc, c):
        cache.drop_prefix_cache()
    assert c.free_pages == jc.free_pages == c.num_pages - 1


def test_fits_request_and_eviction_match_tpudl():
    """Admission does not count a matched prefix's refcount-0 pages both
    as mapped for free and as reclaimable (tpudl's regression), and a
    short pool evicts LRU tree pages in ``_alloc_pages``: the same
    answers, pages and stats as tpudl's."""
    jc, c = _caches(num_pages=10)
    prefix = list(range(100, 108))
    other = [9] * 8
    for cache, (r0, r1) in ((jc, (_rows()[0], _rows(seed=1)[0])),
                            (c, (_rows()[1], _rows(seed=1)[1]))):
        cache.seat_shared(r0, 0, prefix, reserve_tokens=12,
                          lease=cache.match_and_lease(prefix))
        cache.seat_shared(r1, 1, other, reserve_tokens=24,
                          lease=cache.match_and_lease(other))
        cache.free(0)
    _same_state(jc, c)
    assert c.free_pages == 1 and c.radix.evictable_pages == 2
    for tokens in (12, 16):
        assert c.fits_request(prefix, tokens) == jc.fits_request(
            prefix, tokens)
    assert c.fits_request(prefix, 12) and not c.fits_request(prefix, 16)
    assert c.prefix_match_len(prefix) == jc.prefix_match_len(prefix) == 8
    # A third prompt needs more than the free pool: the cached prefix is
    # evicted to seat it.
    third = [5] * 8
    for cache, r in ((jc, _rows(seed=2)[0]), (c, _rows(seed=2)[1])):
        cache.seat_shared(r, 0, third, reserve_tokens=8,
                          lease=cache.match_and_lease(third))
    _same_state(jc, c)
    assert c.radix.stats()["evictions"] == 1


# ---------------------------------------------------------------------------
# the two chunk contracts against tpudl's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", ["host", "device"])
def test_chunk_prefill_matches_tpudl(models, index):
    """A prefix's prefill cache, then the suffix through
    ``chunk_prefill_fn`` at absolute positions: tpudl's last logits and
    written k/v/valid rows, with the write index a host int or the
    shared device tensor the prefix-row gather hands over."""
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 512, size=(1, 13)).astype(np.int32)
    m = 8
    mask = np.ones((1, m), np.int32)
    _, jcache = models["jprefill"](models["jparams"], ids[:, :m], mask)
    jlogits, jcache = jax.jit(jchunk_prefill_fn(models["jmodel"]))(
        models["jparams"], jcache, ids[:, m:],
        np.arange(m, 13, dtype=np.int32)[None, :])
    _, cache = prefill_fn(models["model"])(models["params"], ids[:, :m], mask)
    if index == "device":
        shared = torch.tensor(m)
        for layer in cache["model"].values():
            layer["attention"]["index"] = shared
    logits, cache = chunk_prefill_fn(models["model"])(
        models["params"], cache, ids[:, m:],
        np.arange(m, 13, dtype=np.int32)[None, :])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL,
                               atol=TOL)
    for name, layer in cache["model"].items():
        jl = jcache["model"][name]["attention"]
        for key in ("k", "v", "valid"):
            np.testing.assert_allclose(layer["attention"][key].numpy(),
                                       np.asarray(jl[key]), rtol=TOL,
                                       atol=TOL)
        assert int(layer["attention"]["index"]) == int(jl["index"]) == 13


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_chunk_decode_matches_tpudl(models, kv_dtype):
    """Two slots seated from left-padded prefills, then one verify window
    of 4 tokens a slot through ``paged_chunk_decode_fn``: tpudl's logits
    [B, 4, V] and the written pages; slot 1's window runs past its table
    (a nearly full slot) into the trash page, which no kept row reads."""
    jmodel, jparams = models["jmodel"], models["jparams"]
    model, params = models["model"], models["params"]
    cfg = model.cfg
    jtemplate = jax.eval_shape(
        jprefill_fn(jmodel), jparams, jnp.zeros((2, PROMPT_LEN), jnp.int32),
        jnp.zeros((2, PROMPT_LEN), jnp.int32))[1]
    jc = JPagedKVCache(jtemplate, page_size=PAGE, kv_dtype=kv_dtype)
    c = PagedKVCache(init_cache(cfg, 2, device="meta"), page_size=PAGE,
                     kv_dtype=kv_dtype, device="cpu")
    rng = np.random.default_rng(5)
    for slot, n in enumerate((5, 9)):
        ids = np.zeros((1, PROMPT_LEN), np.int32)
        ids[0, PROMPT_LEN - n:] = rng.integers(1, 512, size=n)
        mask = (ids != 0).astype(np.int32)
        _, jrow = models["jprefill"](jparams, ids, mask)
        _, row = prefill_fn(model)(params, ids, mask)
        reserve = PROMPT_LEN + (8 if slot == 0 else 96 - PROMPT_LEN)
        jc.seat(jrow, slot, PROMPT_LEN - n, PROMPT_LEN, reserve)
        c.seat(row, slot, PROMPT_LEN - n, PROMPT_LEN, reserve)
    # Slot 1 nearly full: its window's last 2 positions pass the table.
    for cache in (jc, c):
        cache.set_len(1, 94)
    tokens = rng.integers(1, 512, size=(2, 4)).astype(np.int32)
    positions = np.array([[5, 6, 7, 8], [83, 84, 85, 86]], np.int32)
    jlogits, jpools = jax.jit(jpaged_chunk_fn(jmodel, PAGE, jc.quantized))(
        jparams, jc.cache, tokens, positions, *jc.dispatch_args())
    logits, pools = paged_chunk_decode_fn(model, PAGE, c.quantized)(
        params, c.cache, tokens, positions, *c.dispatch_args())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for name, layer in pools["model"].items():
        jl = jpools["model"][name]["attention"]
        for key, t in layer["attention"].items():
            # Page 0 is the trash page: the overshoot lands there.
            np.testing.assert_allclose(t.numpy()[1:], np.asarray(jl[key])[1:],
                                       rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# acceptance rules
# ---------------------------------------------------------------------------


def test_acceptance_rules_bit_equal():
    """greedy_accept, sample_accept, softmax, sample_from and the Philox
    draws give tpudl's outputs bit for bit on the same host inputs, and
    tpudl's own unit cases hold."""
    rng = np.random.default_rng(6)
    for trial in range(40):
        k = int(rng.integers(1, 6))
        prop = rng.integers(0, 8, size=k)
        target = np.where(rng.random(k) < 0.7, prop, rng.integers(0, 8, k))
        assert speculate.greedy_accept(prop, target) == jspec.greedy_accept(
            prop, target)
        temp = float(rng.uniform(0.3, 1.5))
        q = [speculate.softmax(rng.normal(size=8) * 2, temp) for _ in range(k)]
        p = [speculate.softmax(rng.normal(size=8) * 2, temp) for _ in range(k)]
        seed, index = int(rng.integers(0, 2**32)), int(rng.integers(0, 500))
        assert speculate.sample_accept(prop, q, p, seed, index) == \
            jspec.sample_accept(prop, q, p, seed, index)
        u = float(speculate._philox(seed, index, 1).random())
        assert u == float(jspec._philox(seed, index, 1).random())
        assert speculate.sample_from(p[0], u) == jspec.sample_from(p[0], u)
        logits = rng.normal(size=16) * 4
        np.testing.assert_array_equal(speculate.softmax(logits, temp),
                                      jspec.softmax(logits, temp))
    assert speculate.greedy_accept([4, 9, 6], [4, 5, 6]) == ([4, 5], 1)
    pp = speculate.softmax(np.asarray([1.0, 2.0, 3.0]), 1.0)
    assert speculate.sample_accept([2, 2], [pp, pp], [pp, pp], 1, 0) == (
        [2, 2], 2)
    for seed in range(8):
        emitted, accepted = speculate.sample_accept(
            [1], [np.asarray([0.0, 1.0, 0.0])], [np.asarray([0.7, 0.0, 0.3])],
            seed, 0)
        assert accepted == 0 and emitted[0] in (0, 2)


# ---------------------------------------------------------------------------
# sessions: the port's tokens are tpudl's
# ---------------------------------------------------------------------------


def test_prefix_session_matches_tpudl(models):
    """Requests seated against a cached prefix give tpudl's tokens and
    cold ``generate()``'s, exactly; the radix cache served prefix tokens
    (the counter, the prefill span's attribute) and its stats are
    tpudl's; a second identical page-aligned prompt (a full-tree hit)
    recomputes only its last token."""
    reg = registry()
    hits0 = reg.counter("serve_prefix_hit_tokens").value
    requests = _shared_requests(4, seed=2)
    ids = np.random.default_rng(5).integers(1, 512, size=12).tolist()
    requests += [Request("a", ids, 6), Request("b", ids, 6)]
    session, jres, res = _serve_both(models, requests, prefix_share=True)
    _same_tokens(requests, jres, res)
    for req in requests:
        np.testing.assert_array_equal(res[req.request_id].tokens,
                                      _generate(models, req))
    assert reg.counter("serve_prefix_hit_tokens").value > hits0
    stats = session.engine.cache.radix.stats()
    assert stats["nodes"] > 0 and stats["splits"] > 0


def test_prefix_eviction_under_pool_pressure(models):
    """A pool too small to cache every prefix evicts LRU refcount-0 tree
    pages instead of refusing admission: tpudl's tokens and evictions."""
    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(dtype=jnp.float32,
                                                       max_seq_len=32))
    jparams = jax.jit(jmodel.init)(
        jax.random.key(2), jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    small = dict(jmodel=jmodel, jparams=jparams,
                 model=LlamaForCausalLM(LLAMA_TINY(dtype=torch.float32,
                                                   max_seq_len=32),
                                        device="meta"),
                 params=_port_params(jparams))
    rng = np.random.default_rng(9)
    requests = [Request(f"e{i}", rng.integers(1, 512, size=12).tolist(), 4)
                for i in range(4)]
    jsession = JSession.from_model(jmodel, jparams, prompt_len=PROMPT_LEN,
                                   num_slots=1, paged=True, page_size=PAGE,
                                   prefix_share=True, num_pages=10)
    session = ServeSession.from_model(
        small["model"], small["params"], prompt_len=PROMPT_LEN, num_slots=1,
        paged=True, page_size=PAGE, prefix_share=True, num_pages=10)
    jres = jsession.serve([JRequest(**dataclasses.asdict(r))
                           for r in requests])
    res = session.serve([dataclasses.replace(r) for r in requests])
    _same_tokens(requests, jres, res)
    assert session.engine.cache.radix.stats()["evictions"] > 0


@pytest.fixture(scope="module")
def spec_served(models):
    """Greedy requests (one ends at an eos inside a window: its 5th token
    of 12, from cold ``generate()``) served by tpudl's speculating
    sessions at k = 2 and 4: (requests, {k: tpudl's results}, the eos
    request's cold tokens)."""
    rng = np.random.default_rng(11)
    requests = [Request(f"s{i}", rng.integers(1, 512, size=int(
        rng.integers(2, PROMPT_LEN + 1))).tolist(), max_new_tokens=10)
        for i in range(3)]
    prompt = [3, 1, 4, 1, 5]
    cold = _generate(models, Request("c", prompt, 12))
    requests.append(Request("e", prompt, max_new_tokens=12,
                            eos_id=int(cold[4])))
    # One int8 self-draft for both of tpudl's sessions (what its default
    # builds), quantized once.
    draft = jquantize_model(models["jmodel"], models["jparams"], "int8")
    jres = {}
    for k in (2, 4):
        jsession = JSession.from_model(
            models["jmodel"], models["jparams"], prompt_len=PROMPT_LEN,
            num_slots=2, paged=True, page_size=PAGE, spec_k=k,
            draft_model=draft[0], draft_params=draft[1])
        jres[k] = jsession.serve([JRequest(**dataclasses.asdict(r))
                                  for r in requests])
    return requests, jres, cold


@pytest.mark.parametrize("k", [2, 4])
def test_spec_session_matches_tpudl(models, spec_served, k):
    """The int8 self-draft proposes k tokens a window; the emitted greedy
    tokens are tpudl's and ``generate()``'s; counters account for every
    window."""
    requests, jres, _ = spec_served
    reg = registry()
    before = {n: reg.counter(n).value for n in (
        "spec_proposed_tokens", "spec_accepted_tokens",
        "spec_emitted_tokens", "spec_slot_steps")}
    session = _sessions(models, spec_k=k)[1]
    res = session.serve([dataclasses.replace(r) for r in requests])
    _same_tokens(requests, jres[k], res)
    for req in requests[:-1]:
        np.testing.assert_array_equal(res[req.request_id].tokens,
                                      _generate(models, req))
    d = {n: reg.counter(n).value - v for n, v in before.items()}
    assert d["spec_emitted_tokens"] == sum(
        len(res[r.request_id].tokens) - 1 for r in requests)
    assert d["spec_proposed_tokens"] == k * d["spec_slot_steps"]
    assert d["spec_accepted_tokens"] / d["spec_slot_steps"] >= 1.0
    assert session.engine.speculator.weight_bytes > 0


def test_spec_eos_mid_window(models, spec_served):
    """An eos accepted inside a window ends the request there (k = 4), as
    non-speculative serving stops at eos: tpudl's tokens."""
    requests, jres, cold = spec_served
    req = requests[-1]
    got = _sessions(models, spec_k=4)[1].serve([dataclasses.replace(req)])[
        req.request_id]
    assert got.tokens == jres[4][req.request_id].tokens
    assert got.finish_reason == "eos" and got.tokens[-1] == req.eos_id
    np.testing.assert_array_equal(got.tokens, cold[:len(got.tokens)])
    assert req.eos_id not in got.tokens[:-1]


def test_spec_full_rejection_rollback(models):
    """A draft with unrelated weights disagrees almost everywhere, so
    windows are (nearly always) fully rejected, and the stream is still
    exactly tpudl's and the non-speculative greedy stream."""
    rng = np.random.default_rng(13)
    requests = [Request(f"g{i}", rng.integers(1, 512, size=6).tolist(), 8)
                for i in range(2)]
    reg = registry()
    acc0 = reg.counter("spec_accepted_tokens").value
    _, jres, res = _serve_both(models, requests, spec_k=3, draft=True)
    _same_tokens(requests, jres, res)
    for req in requests:
        np.testing.assert_array_equal(res[req.request_id].tokens,
                                      _generate(models, req))
    assert reg.counter("spec_accepted_tokens").value - acc0 <= 2


def test_spec_with_prefix_share_composed(models):
    """Radix-shared seating under a speculating engine over int8 KV pages:
    tpudl's tokens."""
    requests = _shared_requests(2, seed=21, max_new=6, tag="c")
    session, jres, res = _serve_both(models, requests, prefix_share=True,
                                     spec_k=3, kv_dtype="int8")
    _same_tokens(requests, jres, res)
    assert session.engine.cache.radix.stats()["nodes"] > 0


def test_spec_sampled_determinism(models):
    """A sampled request reproduces its tokens across sessions and beside
    a neighbour (the per-(request, position) Philox streams)."""
    req = Request("t", [5, 6, 7, 8], max_new_tokens=10, temperature=0.8,
                  seed=42)

    def serve(extra=()):
        session = ServeSession.from_model(
            models["model"], models["params"], prompt_len=PROMPT_LEN,
            num_slots=2, paged=True, page_size=PAGE, spec_k=3)
        return session.serve([dataclasses.replace(req), *extra])["t"].tokens

    first = serve()
    assert len(first) == 10
    assert serve() == first
    assert serve([Request("o", [9, 9, 2], max_new_tokens=10)]) == first


def test_spec_companion_draft_and_refusals(models):
    """A companion draft of another depth gets its own cache template;
    greedy correction keeps the stream exact. prefix_share / spec_k
    without paged, or with adapters, raise as tpudl's; migration still
    raises naming queue A item 3."""
    model, params = models["model"], models["params"]
    jdraft = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(
        dtype=jnp.float32, max_seq_len=96, num_layers=1))
    dparams = _port_params(jax.jit(jdraft.init)(
        jax.random.key(7), jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"])
    session = ServeSession.from_model(
        model, params, prompt_len=PROMPT_LEN, num_slots=2, paged=True,
        page_size=PAGE, spec_k=3, draft_model=_port_model(
            dict(num_layers=1)), draft_params=dparams)
    assert len(session.engine.speculator.cache.cache["model"]) == 1
    req = Request("cd", [7, 8, 9, 10, 11], 8)
    np.testing.assert_array_equal(session.serve([req])["cd"].tokens,
                                  _generate(models, req))
    kw = dict(prompt_len=PROMPT_LEN, num_slots=2)
    for arg in (dict(prefix_share=True), dict(spec_k=3)):
        with pytest.raises(ValueError, match="require paged"):
            ServeSession.from_model(model, params, **arg, **kw)
    with pytest.raises(ValueError, match="draft_params"):
        ServeSession.from_model(model, params, paged=True, spec_k=2,
                                draft_model=model, **kw)
    # Migration of the draft's and the target's rows: an unseated slot
    # does not export, a payload that fails its crc does not import.
    from tpudl_torch.serve.cache import MigrationCorruptError

    spec = session.engine.speculator
    for call in (lambda: spec.export_slot(0, [1], 8),
                 lambda: session.engine.cache.export_request(0, {})):
        with pytest.raises(ValueError, match="not seated"):
            call()
    for call in (lambda: spec.import_slot(0, b"junk"),
                 lambda: session.engine.cache.import_request(b"junk", 0)):
        with pytest.raises(MigrationCorruptError):
            call()
