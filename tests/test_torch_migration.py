"""Page-granular KV migration and the disaggregation inbox: tpudl_torch
against tpudl on the CPU.

The wire format is tpudl's byte for byte (``pack_migration`` on the same
meta and leaves, a bfloat16 leaf included; a paged cache's export of the
same rows), and a payload crosses the packages both ways: one that
tpudl's ``Engine.export_request`` writes mid-stream resumes in the port's
engine with tpudl's tokens, and the reverse. Below that, tpudl's
engine-level migration cases (tests/test_serve_chaos.py,
tests/test_tenant_lora.py, tests/test_serve.py) run on the port: a
round trip with zero prefill on the target, int8 pages shipped as int8
and resumed bit for bit, the crc guard, the deadline (an injected
clock), the prefix by reference, the pad-aligned lease, JSON-unstable
ids, tenants re-pinned or refused, the never-fitting inbox head, the
draft's rows riding along, and prefilled row caches that must outlive
the prefill's output buffer. Tiny f32 Llama (LLAMA_TINY, max_seq_len 96,
prompt window 8, page 8, 2 slots), tpudl's params through
``params_from_tpudl``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models import llama as jllama
from tpudl.models.generate import generate as jgenerate
from tpudl.models.generate import paged_decode_fn as jpaged_decode_fn
from tpudl.models.generate import prefill_fn as jprefill_fn
from tpudl.serve import Request as JRequest
from tpudl.serve import ServeSession as JSession
from tpudl.serve import cache as jcache
from tpudl_torch.models.generate import generate
from tpudl_torch.models.llama import (
    LLAMA_TINY,
    LlamaForCausalLM,
    params_from_tpudl,
)
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.obs import exporter as obs_exporter
from tpudl_torch.serve import PagedKVCache, Request, ServeSession, chaos
from tpudl_torch.serve.cache import (
    MigrationCompatError,
    MigrationCorruptError,
    pack_migration,
    parse_migration,
)
from tpudl_torch.serve.engine import _Migrated, _Prefilled, prefill_handoff
from tpudl_torch.serve.queue import _Entry

PROMPT_LEN = 8
PAGE = 8


@pytest.fixture(autouse=True)
def _clean():
    obs_counters.registry().reset()
    obs_exporter._reset_health_for_tests()
    yield
    obs_counters.registry().reset()
    obs_exporter._reset_health_for_tests()


@pytest.fixture(scope="module")
def programs():
    """tpudl's model, params and compiled prefill / paged decode (shared
    by every tpudl session here: one compile), and the port's model and
    params."""
    jmodel = jllama.LlamaForCausalLM(jllama.LLAMA_TINY(dtype=jnp.float32,
                                                       max_seq_len=96))
    jparams = jmodel.init(jax.random.key(0),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    ids = jax.ShapeDtypeStruct((2, PROMPT_LEN), jnp.int32)
    _, template = jax.eval_shape(jprefill_fn(jmodel), jparams, ids, ids)
    model = LlamaForCausalLM(LLAMA_TINY(dtype=torch.float32, max_seq_len=96),
                             device="meta")
    params = params_from_tpudl(jax.tree.map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, template=template,
                jprefill=jax.jit(jprefill_fn(jmodel)),
                jdecode=jax.jit(jpaged_decode_fn(jmodel, PAGE, False)),
                model=model, params=params)


def _jsession(programs):
    cache = jcache.PagedKVCache(programs["template"], page_size=PAGE)
    return JSession(programs["jprefill"], programs["jdecode"],
                    programs["jparams"], programs["template"], PROMPT_LEN,
                    cache=cache)


def _session(programs, **kw):
    kw = {**dict(prompt_len=PROMPT_LEN, num_slots=2, paged=True,
                 page_size=PAGE), **kw}
    return ServeSession.from_model(programs["model"], programs["params"],
                                   **kw)


def _want(programs, req):
    return generate(programs["model"], programs["params"],
                    torch.as_tensor(req.input_ids)[None, :],
                    max_new_tokens=req.max_new_tokens)[0].numpy()


def _run(session):
    while session.engine.step():
        pass
    return session.engine.results


def _all_free(cache):
    return cache.free_pages == cache.num_pages - 1


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


def _leaf_sets():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(5, 2, 4)).astype(np.float32)
    bits = rng.integers(0, 2**16, size=(3, 2, 4), dtype=np.uint16)
    # bfloat16 words of finite values (the top exponent bits kept low).
    bits = (bits & 0x3FFF) | (bits & 0x8000)
    return {
        "f32": [("['model']['layer_0']['attention']['pages_k']", f32)],
        "int8_scales": [
            ("['model']['layer_0']['attention']['pages_k']",
             rng.integers(-127, 128, size=(5, 2, 4)).astype(np.int8)),
            ("['model']['layer_0']['attention']['scale_k']",
             rng.random((5, 2)).astype(np.float32))],
        "bf16": [("['model']['layer_0']['attention']['pages_v']", bits)],
        "rider_then_int32": [
            ("['x']", f32[:2]),
            ("draft:payload", rng.integers(0, 256, size=13).astype(np.uint8)),
            ("['y']", np.arange(6, dtype=np.int32).reshape(2, 3))],
        "empty_and_scalar": [("['e']", f32[:0]), ("['s']", np.float32(2.5))],
    }


def _as_tpudl(name, arr):
    """The leaf as tpudl holds it (bf16 words -> an ml_dtypes array)."""
    if name == "bf16":
        return np.asarray(arr).view(jnp.bfloat16)
    return arr


def _as_port(name, arr):
    if name == "bf16":
        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


_META = {"kind": "tpudl-kv-migration", "lens": 3, "start": 0,
         "request": {"request_id": "r0", "input_ids": [1, 2, 3],
                     "temperature": 0.5, "deadline_s": None},
         "deadline_at": None, "t_last": 12.25}


@pytest.mark.parametrize("name", sorted(_leaf_sets()))
def test_pack_migration_byte_equal_to_tpudl(name):
    """The same meta and leaves pack to tpudl's bytes (torch tensors and
    numpy arrays alike), and each package parses the other's payload into
    the same shapes, dtype names and bits."""
    leaves = _leaf_sets()[name]
    want = jcache.pack_migration(
        _META, [(p, _as_tpudl(name, a)) for p, a in leaves])
    assert pack_migration(_META, [(p, _as_port(name, a))
                                  for p, a in leaves]) == want
    if name != "bf16":
        assert pack_migration(_META, leaves) == want
    ours, theirs = parse_migration(want), jcache.parse_migration(want)
    assert {k: v for k, v in ours.items() if k != "_arrays"} == {
        k: v for k, v in theirs.items() if k != "_arrays"}
    for path, arr in theirs["_arrays"].items():
        got = ours["_arrays"][path]
        assert tuple(got.shape) == arr.shape
        raw = arr.reshape(-1).view(np.uint8)
        assert (got.reshape(-1).view(torch.uint8).numpy() == raw).all() if \
            got.numel() else raw.size == 0


def test_parse_migration_guards():
    payload = pack_migration(_META, _leaf_sets()["f32"])
    with pytest.raises(MigrationCorruptError, match="crc32"):
        parse_migration(chaos.corrupt_payload(payload))
    with pytest.raises(MigrationCorruptError):
        parse_migration(payload[:len(payload) // 2])
    with pytest.raises(MigrationCorruptError, match="magic"):
        parse_migration(b"NOTAMIGRATION" + payload)
    with pytest.raises(TypeError):
        parse_migration("text")
    # A version this reader does not know, with a valid crc.
    import struct
    import zlib

    body = bytearray(payload[:-4])
    body[8:12] = struct.pack("<I", 2)
    with pytest.raises(MigrationCorruptError, match="version"):
        parse_migration(bytes(body) + struct.pack("<I", zlib.crc32(body)))


# ---------------------------------------------------------------------------
# the paged cache's export and import against tpudl's
# ---------------------------------------------------------------------------


def _templates(num_slots=2, seq=32, hkv=2, hd=4):
    jt = {"model": {f"layer_{i}": {"attention": {
        "k": jax.ShapeDtypeStruct((num_slots, seq, hkv, hd), jnp.float32),
        "v": jax.ShapeDtypeStruct((num_slots, seq, hkv, hd), jnp.float32),
        "valid": jax.ShapeDtypeStruct((num_slots, seq), jnp.bool_),
        "index": jax.ShapeDtypeStruct((), jnp.int32)}} for i in range(11)}}
    t = {"model": {f"layer_{i}": {"attention": {
        "k": torch.empty((num_slots, seq, hkv, hd), device="meta"),
        "v": torch.empty((num_slots, seq, hkv, hd), device="meta"),
        "valid": torch.empty((num_slots, seq), dtype=torch.bool,
                             device="meta"),
        "index": 0}} for i in range(11)}}
    return jt, t


def _rows(seed, seq=32, hkv=2, hd=4):
    rng = np.random.default_rng(seed)
    out = {}
    for pkg in ("j", "t"):
        out[pkg] = {"model": {}}
    for i in range(11):
        k = rng.normal(size=(1, seq, hkv, hd)).astype(np.float32)
        v = rng.normal(size=(1, seq, hkv, hd)).astype(np.float32)
        out["j"]["model"][f"layer_{i}"] = {"attention": {
            "k": jnp.asarray(k), "v": jnp.asarray(v),
            "valid": jnp.ones((1, seq), jnp.bool_), "index": jnp.int32(8)}}
        out["t"]["model"][f"layer_{i}"] = {"attention": {
            "k": torch.from_numpy(k), "v": torch.from_numpy(v),
            "valid": torch.ones((1, seq), dtype=torch.bool), "index": 8}}
    return out["j"], out["t"]


@pytest.mark.parametrize("skip", [0, 4])
def test_cache_export_byte_equal_to_tpudl(skip):
    """Eleven layers (sorted key order puts layer_10 before layer_2): the
    same rows seated in both packages' caches export to the same bytes,
    a reference-skipped export included, and either package's import
    of it restores the other's pools."""
    jt, t = _templates()
    share = bool(skip)
    jc = jcache.PagedKVCache(jt, page_size=4, prefix_share=share)
    c = PagedKVCache(t, page_size=4, prefix_share=share, device="cpu")
    jrow, row = _rows(0)
    ids = list(range(1, 11))
    if share:
        jc.seat_shared(jrow, 1, ids, 20)
        c.seat_shared(row, 1, ids, 20)
    else:
        jc.seat(jrow, 1, 22, 30, 32)
        c.seat(row, 1, 22, 30, 32)
    for cache in (jc, c):
        cache.advance([1], 2)
    meta = {"request": {"input_ids": ids}, "reserve_tokens": 20}
    payload = c.export_request(1, meta, skip_tokens=skip)
    assert payload == jc.export_request(1, meta, skip_tokens=skip)
    jdst = jcache.PagedKVCache(jt, page_size=4, prefix_share=share)
    dst = PagedKVCache(t, page_size=4, prefix_share=share, device="cpu")
    lease = jlease = None
    if share:
        # The target already holds the skipped prefix.
        jdst.seat_shared(jrow, 0, ids[:4] + [50], 8)
        dst.seat_shared(row, 0, ids[:4] + [50], 8)
        jlease, lease = jdst.match_and_lease(ids), dst.match_and_lease(ids)
    jdst.import_request(payload, 1, lease=jlease)
    dst.import_request(payload, 1, lease=lease)
    np.testing.assert_array_equal(dst.page_table, jdst.page_table)
    np.testing.assert_array_equal(dst.lens, jdst.lens)
    np.testing.assert_array_equal(dst.start, jdst.start)
    used = np.unique(dst.page_table[1][:dst.pages_needed(int(dst.lens[1]))])
    for layer, pool in dst.cache["model"].items():
        for name, leaf in pool["attention"].items():
            np.testing.assert_array_equal(
                leaf.numpy()[used],
                np.asarray(jdst.cache["model"][layer]["attention"][name])[used])
    if share:
        assert dst.radix.stats() == jdst.radix.stats()


def test_int8_cache_import_restores_pools_bit_for_bit():
    """int8 pages and their scale rows ship as stored: the import writes
    the source slot's bytes into the target's pages unchanged."""
    _, t = _templates()
    src = PagedKVCache(t, page_size=4, kv_dtype="int8", device="cpu")
    dst = PagedKVCache(t, page_size=4, kv_dtype="int8", device="cpu")
    _, row = _rows(1)
    src.seat(row, 0, 3, 20, 30)
    src.advance([0], 3)
    payload = src.export_request(0, {"request": {"input_ids": [1]},
                                     "reserve_tokens": 30})
    meta = parse_migration(payload)
    dtypes = {path.rsplit("'", 2)[-2]: a.dtype
              for path, a in meta["_arrays"].items()}
    assert dtypes == {"pages_k": torch.int8, "pages_v": torch.int8,
                      "scale_k": torch.float32, "scale_v": torch.float32}
    dst.import_request(payload, 1)
    n = src.pages_needed(23)
    for layer, pool in src.cache["model"].items():
        for name, leaf in pool["attention"].items():
            a = leaf[torch.as_tensor(src.page_table[0, :n], dtype=torch.long)]
            b = dst.cache["model"][layer]["attention"][name][
                torch.as_tensor(dst.page_table[1, :n], dtype=torch.long)]
            # Rows past lens in the last page are zeros on the target.
            a, b = a.reshape(n * 4, -1)[:23], b.reshape(n * 4, -1)[:23]
            assert torch.equal(a.view(torch.uint8) if a.dtype == torch.int8
                               else a, b.view(torch.uint8)
                               if b.dtype == torch.int8 else b)
    assert dst.lens[1] == 23 and dst.start[1] == 3
    with pytest.raises(MigrationCompatError, match="quantization"):
        PagedKVCache(t, page_size=4, device="cpu").import_request(payload, 0)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _mid_stream(session, req, steps, jax_side=False):
    session.submit(JRequest(**dataclasses.asdict(req)) if jax_side else req)
    for _ in range(steps):
        session.engine.step()
    return session.engine.export_request(req.request_id)


@pytest.mark.parametrize("steps", [1, 4])
def test_tpudl_payload_continues_in_port(programs, steps):
    """tpudl's engine exports a greedy request mid-stream; the port's
    engine installs it with no prefill and continues with tpudl's
    tokens."""
    req = Request("x", [3, 5, 7, 11, 2], max_new_tokens=14)
    want = _jsession(programs).serve(
        [JRequest(**dataclasses.asdict(req))])["x"].tokens
    payload = _mid_stream(_jsession(programs), req, steps, jax_side=True)
    dst = _session(programs)
    assert dst.engine.install_migrated(payload) == "x"
    res = _run(dst)["x"]
    assert res.tokens == want and res.finish_reason == "length"
    assert dst.engine.num_prefills == 0
    assert _all_free(dst.engine.cache)


@pytest.mark.parametrize("steps", [1, 4])
def test_port_payload_continues_in_tpudl(programs, steps):
    req = Request("x", [9, 4, 4, 1], max_new_tokens=12)
    want = _session(programs).serve([req])["x"].tokens
    payload = _mid_stream(_session(programs), req, steps)
    dst = _jsession(programs)
    dst.engine.install_migrated(payload)
    while dst.engine.step():
        pass
    assert dst.engine.results["x"].tokens == want
    assert dst.engine.num_prefills == 0


# ---------------------------------------------------------------------------
# engine-level migration (tpudl's tests/test_serve_chaos.py cases)
# ---------------------------------------------------------------------------


def test_migration_roundtrip_byte_exact_zero_prefill(programs):
    src, dst = _session(programs), _session(programs)
    req = Request("r0", [3, 5, 7, 11, 2], max_new_tokens=20)
    src.submit(req)
    for _ in range(5):
        src.engine.step()
    free_before = src.engine.cache.free_pages
    payload = src.engine.export_request("r0")
    assert isinstance(payload, bytes)
    assert all(s is None for s in src.engine._slots)
    assert src.engine.cache.free_pages > free_before
    assert dst.engine.install_migrated(payload) == "r0"
    res = _run(dst)["r0"]
    assert res.finish_reason == "length"
    np.testing.assert_array_equal(np.asarray(res.tokens), _want(programs, req))
    assert dst.engine.num_prefills == 0
    snap = obs_counters.registry().snapshot()["counters"]
    assert snap["serve_migrations_exported"] == 1
    assert snap["serve_migrations_installed"] == 1
    assert snap["serve_migration_payload_bytes"] == len(payload)


def test_migration_int8_pages_ship_as_int8(programs):
    req = Request("r0", [3, 5, 7, 11, 2], max_new_tokens=16)
    want = _session(programs, kv_dtype="int8").serve([req])["r0"]
    src, dst = (_session(programs, kv_dtype="int8") for _ in range(2))
    src.submit(req)
    for _ in range(4):
        src.engine.step()
    payload = src.engine.export_request("r0")
    meta = parse_migration(payload)
    assert meta["quantized"] is True
    kinds = {path.rsplit("'", 2)[-2]: arr.dtype
             for path, arr in meta["_arrays"].items()}
    assert kinds["pages_k"] == torch.int8 and kinds["pages_v"] == torch.int8
    assert kinds["scale_k"] == torch.float32
    dst.engine.install_migrated(payload)
    assert _run(dst)["r0"].tokens == want.tokens
    assert dst.engine.num_prefills == 0


def test_migration_crc_guard(programs):
    """A bit flip raises at the door; through the migrate inbox it
    becomes a ``failed`` Result, nothing seats and every page stays
    free."""
    src = _session(programs)
    src.submit(Request("r0", [3, 5, 7], max_new_tokens=12))
    for _ in range(3):
        src.engine.step()
    payload = src.engine.export_request("r0")
    flipped = chaos.corrupt_payload(payload)
    assert len(flipped) == len(payload)
    assert sum(bin(a ^ b).count("1") for a, b in zip(payload, flipped)) == 1
    dst = _session(programs)
    with pytest.raises(MigrationCorruptError):
        dst.engine.install_migrated(flipped)
    with pytest.raises(MigrationCorruptError):
        parse_migration(payload[:len(payload) // 2])
    dst2 = _session(programs)
    dst2.engine.migrate_inbox.append(_Migrated("r0", flipped))
    assert not dst2.engine.step()
    res = dst2.engine.results["r0"]
    assert res.finish_reason.startswith("failed: MigrationCorruptError")
    assert res.tokens == [] and not res.ok
    assert all(s is None for s in dst2.engine._slots)
    assert _all_free(dst2.engine.cache)
    snap = obs_counters.registry().snapshot()["counters"]
    assert snap["serve_migrations_failed"] == 1
    # The hop count rides the payload (export stamps hops survived).
    assert parse_migration(payload)["migrations"] == 0


def test_flip_migration_knob_corrupts_every_received_payload(programs,
                                                           monkeypatch):
    """TPUDL_SERVE_CHAOS_FLIP_MIGRATION flips a bit of every payload an
    engine receives: a direct install raises at the crc, the inbox's
    ends ``failed`` with every page free; the same bytes install once the
    knob is off."""
    src = _session(programs)
    req = Request("r0", [3, 5, 7], max_new_tokens=12)
    src.submit(req)
    for _ in range(3):
        src.engine.step()
    payload = src.engine.export_request("r0")
    monkeypatch.setenv("TPUDL_SERVE_CHAOS_FLIP_MIGRATION", "1")
    dst = _session(programs)
    with pytest.raises(MigrationCorruptError):
        dst.engine.install_migrated(payload)
    assert _all_free(dst.engine.cache)
    dst.engine.migrate_inbox.append(_Migrated("r0", payload))
    assert not dst.engine.step()
    res = dst.engine.results["r0"]
    assert res.finish_reason.startswith("failed: MigrationCorruptError")
    assert _all_free(dst.engine.cache)
    monkeypatch.delenv("TPUDL_SERVE_CHAOS_FLIP_MIGRATION")
    dst.engine.results.clear()
    dst.engine.install_migrated(payload)
    np.testing.assert_array_equal(np.asarray(_run(dst)["r0"].tokens),
                                  _want(programs, req))


def test_preempt_hook_migrates_seated_requests(programs, monkeypatch):
    """TPUDL_SERVE_CHAOS_PREEMPT_STEP raises ChaosPreempt at the top of
    ``step``, before the step's work: the caller catches it, exports
    every seated request and a survivor resumes them with no prefill,
    their tokens the unmigrated run's."""
    reqs = [Request("a", [3, 5, 7, 11, 2], max_new_tokens=14),
            Request("b", [9, 4], max_new_tokens=10)]
    dst = _session(programs)
    monkeypatch.setenv("TPUDL_SERVE_CHAOS_PREEMPT_STEP", "4")
    src = _session(programs)
    for r in reqs:
        src.submit(r)
    with pytest.raises(chaos.ChaosPreempt):
        while src.engine.step():
            pass
    assert src.engine.num_decode_steps == 4
    seated = [s.request.request_id for s in src.engine._slots if s]
    assert sorted(seated) == ["a", "b"]
    for rid in seated:
        dst.engine.install_migrated(src.engine.export_request(rid))
    assert _all_free(src.engine.cache)
    got = _run(dst)
    assert dst.engine.num_prefills == 0
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(got[r.request_id].tokens),
                                      _want(programs, r))


def test_migration_deadline_rides_payload(programs):
    """The absolute deadline rides the payload: a transfer that used up
    the budget sheds as shed_timeout; inside it the request seats and
    completes (an injected clock, no sleeping)."""
    t = [100.0]
    clock = lambda: t[0]  # noqa: E731
    src = _session(programs, clock=clock)
    src.submit(Request("r0", [3, 5, 7], max_new_tokens=12, deadline_s=0.4))
    src.engine.step()
    stamp = next(s for s in src.engine._slots if s is not None).entry.deadline
    assert stamp == pytest.approx(100.4)
    payload = src.engine.export_request("r0")
    assert parse_migration(payload)["deadline_at"] == stamp
    t[0] += 0.5  # the transfer "took" longer than the budget left
    dst = _session(programs, clock=clock)
    dst.engine.install_migrated(payload)
    assert dst.engine.results["r0"].finish_reason == "shed_timeout"
    assert all(s is None for s in dst.engine._slots)
    assert _all_free(dst.engine.cache)
    src2 = _session(programs, clock=clock)
    src2.submit(Request("r1", [3, 5, 7], max_new_tokens=12, deadline_s=60.0))
    src2.engine.step()
    dst2 = _session(programs, clock=clock)
    dst2.engine.install_migrated(src2.engine.export_request("r1"))
    assert _run(dst2)["r1"].ok


def test_migration_prefix_reference_first(programs):
    """A target-cached prefix ships by reference (pre-leased), shrinking
    the payload by exactly its rows; a cold target refuses the
    reference-only payload and seats the full one, whose full pages
    enter its radix tree."""
    def mk_share():
        return _session(programs, prompt_len=3 * PAGE, prefix_share=True)

    shared = list(range(2, 2 + PAGE))  # one full page
    prompt = shared + [31, 37, 41]
    dst = mk_share()
    dst.submit(Request("warm", shared + [51, 52], max_new_tokens=3))
    dst.collect()

    def export_from_fresh_source(skip):
        src = mk_share()
        src.submit(Request("r0", prompt, max_new_tokens=12))
        for _ in range(3):
            src.engine.step()
        return src.engine.export_request("r0", skip_prefix_tokens=skip)

    skip = dst.engine.cache.prefix_match_len(prompt)
    assert skip == PAGE
    lease = dst.engine.cache.match_and_lease(prompt)
    full_payload = export_from_fresh_source(0)
    ref_payload = export_from_fresh_source(skip)
    full_meta, ref_meta = (parse_migration(p)
                           for p in (full_payload, ref_payload))
    row_bytes = sum(a[0].numel() * a.element_size()
                    for a in full_meta["_arrays"].values())
    assert (sum(d["nbytes"] for d in full_meta["arrays"])
            - sum(d["nbytes"] for d in ref_meta["arrays"])) == PAGE * row_bytes
    assert ref_meta["skip_tokens"] == PAGE
    dst.engine.install_migrated(ref_payload, lease=lease)
    res = _run(dst)["r0"]
    want = _want(programs, Request("r0", prompt, max_new_tokens=12))
    np.testing.assert_array_equal(np.asarray(res.tokens), want)
    cold = mk_share()
    with pytest.raises(MigrationCompatError, match="reference"):
        cold.engine.install_migrated(export_from_fresh_source(skip))
    cold.engine.install_migrated(export_from_fresh_source(0))
    assert _run(cold)["r0"].ok
    assert cold.engine.cache.prefix_match_len(prompt) >= PAGE


def test_pad_aligned_payload_ignores_prepinned_lease(programs):
    share = _session(programs, prompt_len=2 * PAGE, prefix_share=True)
    prompt = list(range(2, 2 + PAGE)) + [31, 37]
    share.submit(Request("warm", prompt[:PAGE] + [51], max_new_tokens=3))
    share.collect()
    src = _session(programs, prompt_len=2 * PAGE)
    src.submit(Request("r0", prompt, max_new_tokens=10))
    for _ in range(3):
        src.engine.step()
    assert int(src.engine.cache.start[0]) > 0
    payload = src.engine.export_request("r0")
    assert parse_migration(payload)["left_aligned"] is False
    evictable_before = share.engine.cache.radix.evictable_pages
    lease = share.engine.cache.match_and_lease(prompt)
    share.engine.install_migrated(payload, lease=lease)
    assert share.engine.cache.radix.evictable_pages == evictable_before
    res = _run(share)["r0"]
    np.testing.assert_array_equal(
        np.asarray(res.tokens),
        _want(programs, Request("r0", prompt, max_new_tokens=10)))


def test_export_declines_json_unstable_request_ids(programs):
    src = _session(programs)
    src.submit(Request(("user7", 42), [3, 5, 7], max_new_tokens=8))
    src.engine.step()
    assert src.engine.export_request(("user7", 42)) is None
    assert src.engine.export_request("not-seated") is None
    assert _run(src)[("user7", 42)].ok
    dense = ServeSession.from_model(programs["model"], programs["params"],
                                    prompt_len=PROMPT_LEN, num_slots=2)
    dense.submit(Request("d", [3, 5], max_new_tokens=4))
    dense.engine.step()
    assert dense.engine.export_request("d") is None
    with pytest.raises(ValueError, match="paged"):
        dense.engine.install_migrated(b"")


def test_reference_payload_in_inbox_of_cold_target_fails(programs):
    """A reference-skipped payload is whole only against the tree it was
    probed on: in a cold target's migrate inbox it ends ``failed``
    (MigrationCompatError, its lease-free pages all back), while the full
    payload behind it seats and completes."""
    src = _session(programs)
    for rid in ("r0", "r1"):
        src.submit(Request(rid, [3, 5, 7, 11, 2, 9, 4, 6], max_new_tokens=8))
    for _ in range(2):
        src.engine.step()
    meta = parse_migration(src.engine.export_request("r0"))
    meta["skip_tokens"] = PAGE
    holey = pack_migration(
        {k: v for k, v in meta.items() if k not in ("_arrays", "arrays")},
        [])
    full = src.engine.export_request("r1")
    dst = _session(programs, prefix_share=True)
    dst.engine.migrate_inbox.append(_Migrated("r0", holey))
    dst.engine.migrate_inbox.append(_Migrated("r1", full))
    assert dst.engine.health()["queue_depth"] == 2
    _run(dst)
    res = dst.engine.results["r0"]
    assert res.finish_reason.startswith("failed: MigrationCompatError")
    assert "reference" in res.finish_reason and res.tokens == []
    assert dst.engine.results["r1"].ok
    assert not dst.engine.migrate_inbox
    assert dst.engine.cache.radix.stats()["evictable_pages"] == (
        dst.engine.cache.num_pages - 1 - dst.engine.cache.free_pages)


# ---------------------------------------------------------------------------
# adapters (tpudl's tests/test_tenant_lora.py migration cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def adapters():
    from tests.test_torch_tenant_lora import TINY, make_adapter

    jmodel = jllama.LlamaForCausalLM(jllama.LlamaConfig(**TINY,
                                                        dtype=jnp.float32))
    jparams = jmodel.init(jax.random.key(0),
                          jnp.zeros((1, PROMPT_LEN), jnp.int32))["params"]
    from tpudl_torch.models.llama import LlamaConfig

    model = LlamaForCausalLM(LlamaConfig(**TINY, dtype=torch.float32),
                             device="meta")
    params = params_from_tpudl(jax.tree.map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    return model, params, {"t0": make_adapter(1), "t1": make_adapter(2)}


def test_migration_repins_adapter_on_target(adapters):
    from tpudl_torch.models.lora import merge_adapter

    model, params, ads = adapters

    def mk():
        return ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                       num_slots=2, adapters=ads)

    src, dst = mk(), mk()
    src.submit(Request("mig", [9, 8, 7, 6], max_new_tokens=16, tenant="t0"))
    for _ in range(5):
        src.engine.step()
    payload = src.engine.export_request("mig")
    assert parse_migration(payload)["request"]["tenant"] == "t0"
    assert dst.engine.adapter_pool.resident_since("t0") is None
    dst.engine.install_migrated(payload)
    assert dst.engine.adapter_pool.resident_since("t0") is not None
    assert dst.engine.num_prefills == 0
    res = _run(dst)["mig"]
    assert res.ok
    want = generate(model, merge_adapter(params, ads["t0"]),
                    torch.as_tensor([[9, 8, 7, 6]]), max_new_tokens=16)[0]
    np.testing.assert_array_equal(np.asarray(res.tokens), want.numpy())


def test_migration_refused_without_target_pool(adapters):
    model, params, ads = adapters
    src = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                  num_slots=2, adapters={"t0": ads["t0"]})
    dst = ServeSession.from_model(model, params, prompt_len=PROMPT_LEN,
                                  num_slots=2, paged=True)
    src.submit(Request("m2", [4, 5, 6], max_new_tokens=8, tenant="t0"))
    for _ in range(3):
        src.engine.step()
    payload = src.engine.export_request("m2")
    with pytest.raises(MigrationCompatError, match="adapter pool"):
        dst.engine.install_migrated(payload)
    assert _all_free(dst.engine.cache)


# ---------------------------------------------------------------------------
# the disaggregation inbox
# ---------------------------------------------------------------------------


def _prefilled(engine, req, t=0.0):
    ids = np.asarray(req.input_ids, np.int32)
    pad = PROMPT_LEN - ids.shape[0]
    padded = np.concatenate([np.zeros(pad, np.int32), ids])[None, :]
    mask = np.concatenate([np.zeros(pad, np.int32),
                           np.ones(ids.shape[0], np.int32)])[None, :]
    from tpudl_torch.serve.engine import first_token

    logits, row_cache = engine.prefill_call(engine.params, padded, mask)
    return _Prefilled(_Entry(priority=0, seq=0, request=req, deadline=None,
                             submitted_at=t),
                      row_cache, first_token(logits, req), int(ids.shape[0]),
                      t, t)


def test_never_fitting_prefill_inbox_head_sheds(programs):
    session = ServeSession.from_model(programs["model"], programs["params"],
                                      prompt_len=PROMPT_LEN, num_slots=2)
    engine = session.engine
    huge = Request("huge", [1, 2, 3], max_new_tokens=96)
    assert PROMPT_LEN + huge.max_new_tokens > engine.max_seq_len
    ok = Request("ok", [4, 5], max_new_tokens=3)
    engine.prefill_inbox.append(_prefilled(engine, huge))
    engine.prefill_inbox.append(_prefilled(engine, ok))
    engine.run_until_drained()
    assert engine.results["huge"].finish_reason == "shed_capacity"
    assert engine.results["huge"].tokens == []
    assert engine.results["ok"].finish_reason == "length"
    assert len(engine.results["ok"].tokens) == 3
    assert not engine.prefill_inbox


class _ReusedOutput:
    """A prefill whose row cache is one buffer every call rewrites (what a
    captured prefill returns: the graph's output buffers)."""

    def __init__(self, fn):
        self.fn, self.out = fn, None

    def __call__(self, *args):
        logits, rows = self.fn(*args)
        if self.out is None:
            self.out = rows
        else:
            _copy_into(self.out, rows)
        return logits, self.out


def _copy_into(dst, src):
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        elif isinstance(v, torch.Tensor):
            v.copy_(src[k])


@pytest.mark.parametrize("paged", [False, True])
def test_prefilled_back_to_back_then_seated(programs, paged):
    """Two requests prefilled one after the other on a prefill that
    rewrites its output buffer, both handed to another engine before
    either is seated: each seats its own rows (zero prefills on the
    target) and both continue as generate() does."""
    a = _session(programs) if paged else ServeSession.from_model(
        programs["model"], programs["params"], prompt_len=PROMPT_LEN,
        num_slots=2)
    b = _session(programs) if paged else ServeSession.from_model(
        programs["model"], programs["params"], prompt_len=PROMPT_LEN,
        num_slots=2)
    a.engine.prefill_call = _ReusedOutput(a.engine.prefill_call)
    reqs = [Request("p", [3, 5, 7, 11, 2], max_new_tokens=9),
            Request("q", [8, 1, 6], max_new_tokens=7)]
    items = [prefill_handoff(a.engine, r) for r in reqs]
    assert a.engine.num_prefills == 2
    b.engine.prefill_inbox.extend(items)
    assert b.engine.health()["queue_depth"] == 2
    results = _run(b)
    assert b.engine.num_prefills == 0
    for r in reqs:
        np.testing.assert_array_equal(np.asarray(results[r.request_id].tokens),
                                      _want(programs, r))


def test_prefilled_into_prefix_share_engine(programs):
    """A handed-off full-prefill row seats left-aligned in a radix
    engine: matched pages dedup, the rest scatters from the row."""
    shared = list(range(2, 2 + PAGE))
    a = _session(programs, prompt_len=2 * PAGE)
    b = _session(programs, prompt_len=2 * PAGE, prefix_share=True)
    b.serve([Request("warm", shared + [60], max_new_tokens=2)])
    req = Request("h", shared + [31, 37], max_new_tokens=6)
    b.engine.prefill_inbox.append(prefill_handoff(a.engine, req))
    p0 = b.engine.num_prefills
    res = _run(b)["h"]
    assert b.engine.num_prefills == p0
    np.testing.assert_array_equal(np.asarray(res.tokens), _want(programs, req))


# ---------------------------------------------------------------------------
# speculation, sampling and the failover gap
# ---------------------------------------------------------------------------


def test_spec_migration_ships_draft_rows(programs):
    """A speculating engine's export carries the draft's rows as a nested
    payload; the target resumes in lockstep with no prefill, target or
    draft, and its tokens are the unmigrated speculating run's."""
    req = Request("s", [3, 5, 7, 11, 2], max_new_tokens=14)
    want = _session(programs, spec_k=2).serve([req])["s"].tokens
    src, dst = _session(programs, spec_k=2), _session(programs, spec_k=2)
    src.submit(req)
    for _ in range(3):
        src.engine.step()
    payload = src.engine.export_request("s")
    meta = parse_migration(payload)
    assert meta["draft"]["k"] == 2
    draft = parse_migration(meta["_arrays"]["draft:payload"].numpy().tobytes())
    assert draft["lens"] == meta["lens"]
    assert _all_free(src.engine.speculator.cache)
    calls = []
    spec = dst.engine.speculator
    real = spec.prefill_call
    spec.prefill_call = lambda *a: calls.append(1) or real(*a)
    dst.engine.install_migrated(payload)
    slot = next(i for i, s in enumerate(dst.engine._slots) if s is not None)
    assert spec.cache.lens[slot] == dst.engine.cache.lens[slot]
    assert _run(dst)["s"].tokens == want
    assert dst.engine.num_prefills == 0 and calls == []
    # A speculating target refuses a draft-less payload; a plain target
    # ignores the rider.
    plain = _session(programs)
    plain.engine.install_migrated(payload)
    assert _run(plain)["s"].ok
    with pytest.raises(MigrationCompatError, match="draft"):
        _session(programs, spec_k=2).engine.install_migrated(
            _mid_stream(_session(programs), Request("n", [1, 2], 6), 2))


def test_sampled_request_continues_its_stream(programs):
    """A sampled request resumes at its recorded fold_in token index: the
    migrated tokens are the unmigrated run's."""
    req = Request("t", [3, 5, 7], max_new_tokens=12, temperature=0.9,
                  seed=1234)
    want = _session(programs).serve([req])["t"].tokens
    payload = _mid_stream(_session(programs), req, 5)
    assert parse_migration(payload)["steps"] == 6
    dst = _session(programs)
    dst.engine.install_migrated(payload)
    assert _run(dst)["t"].tokens == want


def test_failover_gap_and_hops_on_injected_clock(programs):
    t = [10.0]
    clock = lambda: t[0]  # noqa: E731
    src = _session(programs, clock=clock)
    src.submit(Request("g", [3, 5], max_new_tokens=8))
    for _ in range(2):
        t[0] += 1.0
        src.engine.step()
    payload = src.engine.export_request("g")
    assert parse_migration(payload)["t_last"] == 12.0
    t[0] = 20.0
    dst = _session(programs, clock=clock)
    dst.engine.install_migrated(payload)
    t[0] = 20.25
    dst.engine.step()
    gap = obs_counters.registry().histogram("serve_failover_token_gap_ms")
    assert gap.values == [pytest.approx(8250.0)]
    again = dst.engine.export_request("g")
    assert parse_migration(again)["migrations"] == 1
    third = _session(programs, clock=clock)
    third.engine.install_migrated(again)
    slot = next(s for s in third.engine._slots if s is not None)
    assert slot.migrations == 2
    assert _run(third)["g"].ok
    assert len(gap.values) == 2
