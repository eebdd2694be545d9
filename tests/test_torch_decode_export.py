"""The port's serving export (tpudl_torch.export.decode), its artifact
sessions and generate()'s chunked decode, against tpudl on the CPU.

tpudl's LLAMA_TINY weights go through ``params_from_tpudl`` into the port
(f32). The port's ``torch.export`` artifacts (parameters and cache as
explicit inputs) must reproduce, token for token, the port's live
``generate()`` and tpudl's ``generate_with_exported`` over tpudl's
StableHLO artifacts of the same weights: ragged left-padded batches, eos
padding and the early exit's decode-call count mirror
tests/test_decode_export.py. ``ServeSession.from_artifacts`` must recover
the shapes tpudl's recovers from its artifacts of the same config, dense
and paged. ``generate()``'s chunked loop must give the per-token loop's
tokens bit for bit, greedy and sampled, tpudl's greedy tokens, and
tpudl's chunk count and early exit (tests/test_generate.py:225-260).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.export import decode as jdecode
from tpudl.models import llama as jllama
from tpudl.serve.api import ServeSession as JSession
from tpudl_torch.export import decode as tdecode
from tpudl_torch.export.export import load_exported_obj
from tpudl_torch.models import llama as tllama
from tpudl_torch.ops.library import graph_ops
from tpudl_torch.serve import Request, ServeSession

# The packages re-export a ``generate`` function under the module's name.
jgen = importlib.import_module("tpudl.models.generate")
tgen = importlib.import_module("tpudl_torch.models.generate")

pytestmark = pytest.mark.needs_jax_export

MAX_SEQ = 64
B, S, NEW = 2, 8, 12


@pytest.fixture(scope="module")
def tiny():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jmodel = jllama.LlamaForCausalLM(
        jllama.LLAMA_TINY(dtype=jnp.float32, max_seq_len=MAX_SEQ))
    ids = np.random.default_rng(3).integers(5, 500, (B, S)).astype(np.int32)
    jparams = jmodel.init(jax.random.key(0), jnp.asarray(ids))["params"]
    tmodel = tllama.LlamaForCausalLM(
        tllama.LLAMA_TINY(dtype=torch.float32, max_seq_len=MAX_SEQ),
        device="meta")
    tparams = tllama.params_from_tpudl(jax.tree.map(np.asarray, jparams),
                                       dtype=torch.float32, device="cpu")
    yield jmodel, jparams, tmodel, tparams, ids
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def artifacts(tiny):
    """The port's (prefill, decode) pair at [B, S], loaded."""
    _, _, tmodel, tparams, _ = tiny
    return tdecode.load_decoder(*tdecode.export_decoder(tmodel, tparams, B, S))


def _ragged(ids):
    mask = np.ones((B, S), np.int32)
    mask[1, :3] = 0
    ragged = ids.copy()
    ragged[1, :3] = 0
    return ragged, mask


def test_exported_roundtrip_matches_generate_and_tpudl(tiny, tmp_path):
    """Export to files, load, generate: the port's live generate() and
    tpudl's generate_with_exported over its own artifacts, token for
    token; the loop enforces the exporting model's cache bound."""
    jmodel, jparams, tmodel, tparams, ids = tiny
    prefix = str(tmp_path / "llama_tiny")
    tdecode.export_decoder(tmodel, tparams, B, S, path_prefix=prefix)
    pre, dec = tdecode.load_decoder(f"{prefix}.prefill.pt2",
                                    f"{prefix}.decode.pt2")
    got = tdecode.generate_with_exported(pre, dec, tparams, ids,
                                         max_new_tokens=NEW,
                                         max_seq_len=MAX_SEQ)
    live = tgen.generate(tmodel, tparams, ids, max_new_tokens=NEW)
    jpre, jdec = jdecode.load_decoder(
        *jdecode.export_decoder(jmodel, jparams, B, S))
    want = jdecode.generate_with_exported(jpre, jdec, jparams,
                                          jnp.asarray(ids),
                                          max_new_tokens=NEW)
    np.testing.assert_array_equal(got.numpy(), live.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="max_seq_len"):
        tdecode.generate_with_exported(pre, dec, tparams, ids,
                                       max_new_tokens=MAX_SEQ,
                                       max_seq_len=MAX_SEQ)


def test_exported_ragged_padded_batch(tiny, artifacts):
    """A left-padded row reproduces its unpadded generation through the
    artifacts (the cache's validity is an explicit input), as tpudl's
    artifacts do; a right-padded mask raises."""
    _, _, tmodel, tparams, ids = tiny
    pre, dec = artifacts
    ragged, mask = _ragged(ids)
    got = tdecode.generate_with_exported(pre, dec, tparams, ragged, mask,
                                         max_new_tokens=NEW,
                                         max_seq_len=MAX_SEQ)
    want0 = tgen.generate(tmodel, tparams, ids[0:1], max_new_tokens=NEW)
    want1 = tgen.generate(tmodel, tparams, ids[1:2, 3:], max_new_tokens=NEW)
    np.testing.assert_array_equal(got[0].numpy(), want0[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want1[0].numpy())
    with pytest.raises(ValueError, match="LEFT-padded"):
        tdecode.generate_with_exported(pre, dec, tparams, ragged,
                                       mask[:, ::-1].copy(), max_new_tokens=2)


def test_exported_eos_padding(tiny, artifacts):
    _, _, _, tparams, ids = tiny
    pre, dec = artifacts
    first = tdecode.generate_with_exported(pre, dec, tparams, ids,
                                           max_new_tokens=3)
    eos = int(first[0, 0])
    row = tdecode.generate_with_exported(pre, dec, tparams, ids,
                                         max_new_tokens=5, eos_id=eos)[0]
    assert row[0] == eos and bool((row == eos).all())


def test_exported_early_exit_skips_decode_calls(tiny):
    """tests/test_decode_export.py's counts on the port: a batch done at
    its first token calls decode zero times; a live row every time; a
    mid-stream finish with per-token checks exactly up to the eos."""
    _, _, tmodel, tparams, ids = tiny
    pre, dec = tdecode.load_decoder(*tdecode.export_decoder(tmodel, tparams,
                                                            1, S))
    calls = []

    def counting(*args):
        calls.append(1)
        return dec(*args)

    row = ids[0:1]
    eos0 = int(tdecode.generate_with_exported(pre, dec, tparams, row,
                                              max_new_tokens=1)[0, 0])
    got = tdecode.generate_with_exported(pre, counting, tparams, row,
                                         max_new_tokens=10, eos_id=eos0)
    assert not calls and got.shape == (1, 10) and bool((got == eos0).all())
    probe = tdecode.generate_with_exported(pre, dec, tparams, row,
                                           max_new_tokens=6)[0].numpy()
    never = next(t for t in range(512) if t not in set(probe))
    got2 = tdecode.generate_with_exported(pre, counting, tparams, row,
                                          max_new_tokens=6, eos_id=never)
    assert got2.shape == (1, 6) and len(calls) == 5
    eos_mid = int(probe[3])
    hit = int(np.argmax(probe == eos_mid))
    calls.clear()
    got3 = tdecode.generate_with_exported(pre, counting, tparams, row,
                                          max_new_tokens=12, eos_id=eos_mid,
                                          eos_check_every=1)[0].numpy()
    assert len(calls) == hit
    assert got3[hit] == eos_mid and np.all(got3[hit:] == eos_mid)
    with pytest.raises(ValueError, match="eos_check_every"):
        tdecode.generate_with_exported(pre, dec, tparams, row,
                                       max_new_tokens=2, eos_id=0,
                                       eos_check_every=0)


def test_fused_decode_artifact_holds_the_ops_and_runs_the_plain_versions(
        tiny, artifacts):
    """A fused_ops=True model's decode artifact holds one tpudl::rms_norm
    per norm (2 a layer + the final one) and one tpudl::swiglu a layer;
    on the CPU those run the plain versions (the artifact's logits equal
    the live decode's bit for bit). impl="fused" on a CPU tensor still
    raises before any op."""
    from tpudl_torch.ops.norms import rms_norm

    _, _, tmodel, tparams, ids = tiny
    assert tmodel.cfg.fused_ops is True
    pre_blob, dec_blob = tdecode.export_decoder(tmodel, tparams, B, S)
    for blob in (pre_blob, dec_blob):
        assert graph_ops(load_exported_obj(blob).graph_module) == {
            "rms_norm": 2 * 2 + 1, "swiglu": 2}
    pre, dec = tdecode.load_decoder(pre_blob, dec_blob)
    mask = np.ones_like(ids)
    logits, cache = pre(tparams, torch.as_tensor(ids), torch.as_tensor(mask))
    live, _ = tgen.prefill_fn(tmodel)(tparams, ids, mask)
    assert torch.equal(logits, live)
    token = logits.argmax(-1).to(torch.int32)
    position = torch.full((B,), S, dtype=torch.int32)
    cache = tdecode.device_index_cache(cache)
    live_cache = tdecode.device_index_cache(
        tgen.prefill_fn(tmodel)(tparams, ids, mask)[1])
    got, _ = dec(tparams, cache, token, position)
    want, _ = tgen.decode_fn(tmodel)(tparams, live_cache, token, position)
    assert torch.equal(got, want)
    assert int(cache["model"]["layer_1"]["attention"]["index"]) == S + 1
    x = torch.ones(2, 128)
    with pytest.raises(ValueError, match="fused"):
        rms_norm(x, torch.ones(128), impl="fused")


def _requests(seed=2, n=5):
    rng = np.random.default_rng(seed)
    return [Request(f"r{i}", rng.integers(1, 500, int(rng.integers(
        2, S + 1))).tolist(), max_new_tokens=6) for i in range(n)]


@pytest.mark.parametrize("paged", [False, True])
def test_from_artifacts_recovers_tpudl_shapes_and_serves(tiny, paged):
    """The same serving config exported by both packages: the port's
    artifact session reads back tpudl's slot count, prompt window, cache
    bound and (paged) page size, pool size and page span, and serves the
    greedy tokens of the port's model session (which
    tests/test_torch_serve.py holds to tpudl's). A params dict with another key set raises naming the key."""
    jmodel, jparams, tmodel, tparams, _ = tiny
    kw = dict(paged=True, page_size=4, num_pages=20) if paged else {}
    jsession = JSession.from_artifacts(
        *jdecode.export_serving_decoder(jmodel, jparams, 3, S, **kw),
        jparams, paged=paged)
    blobs = tdecode.export_serving_decoder(tmodel, tparams, 3, S, **kw)
    session = ServeSession.from_artifacts(*blobs, tparams, paged=paged)
    assert (session.num_slots, session.prompt_len, session.max_seq_len) == (
        jsession.num_slots, jsession.prompt_len, jsession.max_seq_len) == (
        3, S, MAX_SEQ)
    if paged:
        mine, theirs = session.engine.cache, jsession.engine.cache
        for attr in ("page_size", "num_pages", "pages_per_slot"):
            assert getattr(mine, attr) == getattr(theirs, attr), attr
    reqs = _requests()
    got = session.serve([Request(**r.__dict__) for r in reqs])
    live = ServeSession.from_model(tmodel, tparams, prompt_len=S, num_slots=3,
                                   **kw).serve(
        [Request(**r.__dict__) for r in reqs])
    for r in reqs:
        assert got[r.request_id].tokens == live[r.request_id].tokens
    with pytest.raises(ValueError, match="was requested"):
        ServeSession.from_artifacts(*blobs, tparams, paged=not paged)
    extra = {**tparams, "lm_head.extra": tparams["lm_head.weight"]}
    with pytest.raises(ValueError, match="lm_head.extra"):
        ServeSession.from_artifacts(*blobs, extra)
    shuffled = dict(reversed(list(tparams.items())))
    again = ServeSession.from_artifacts(*blobs, shuffled).serve(
        [Request(**reqs[0].__dict__)])
    assert again["r0"].tokens == got["r0"].tokens


def test_chunked_generate_matches_the_token_loop_and_tpudl(tiny):
    """Greedy: the chunked loop, the per-token loop and tpudl's generate()
    agree on a ragged batch. Sampled (temperature, top-k, top-p, eos): the
    chunked loop gives the per-token loop's tokens from the same
    generator seed."""
    jmodel, jparams, tmodel, tparams, ids = tiny
    ragged, mask = _ragged(ids)
    kw = dict(max_new_tokens=NEW, eos_check_every=4)
    got = tgen.generate(tmodel, tparams, ragged, mask, **kw)
    loop = tgen.generate(tmodel, tparams, ragged, mask, chunked=False, **kw)
    want = jgen.generate(jmodel, jparams, jnp.asarray(ragged),
                         jnp.asarray(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), loop.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sampled = dict(temperature=0.8, top_k=40, top_p=0.9, eos_id=int(got[0, 4]),
                   **kw)
    a = tgen.generate(tmodel, tparams, ragged, mask,
                      generator=torch.Generator().manual_seed(7), **sampled)
    b = tgen.generate(tmodel, tparams, ragged, mask, chunked=False,
                      generator=torch.Generator().manual_seed(7), **sampled)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_chunk_count_early_exit_and_chunk_keys(tiny, monkeypatch):
    """tests/test_generate.py:225-260 on the port: a batch done at its
    first token runs no chunk, an eos at token index h with chunks of 4
    runs ceil(h / 4) chunks, and varying temperature / top-p reuses the
    chunk length's and the remainder's keys (at most two)."""
    _, _, tmodel, tparams, ids = tiny
    row = ids[0:1]
    probe = tgen.generate(tmodel, tparams, row, max_new_tokens=10)[0].numpy()
    calls = []
    real = tgen._decode_chunk

    def counting(decode, params, state, steps, greedy, top_k, has_top_p,
                 has_eos, generator):
        calls.append((steps, greedy, top_k, has_top_p, has_eos))
        return real(decode, params, state, steps, greedy, top_k, has_top_p,
                    has_eos, generator)

    monkeypatch.setattr(tgen, "_decode_chunk", counting)
    got = tgen.generate(tmodel, tparams, row, max_new_tokens=30,
                        eos_id=int(probe[0]), eos_check_every=4)
    assert not calls and bool((got == int(probe[0])).all())
    eos_mid = int(probe[5])
    hit = int(np.argmax(probe == eos_mid))
    tgen.generate(tmodel, tparams, row, max_new_tokens=30, eos_id=eos_mid,
                  eos_check_every=4)
    assert len(calls) == -(-hit // 4)
    calls.clear()
    for temp, top_p in ((0.7, 0.9), (0.8, 0.95), (1.3, 0.5)):
        tgen.generate(tmodel, tparams, ids, max_new_tokens=9,
                      temperature=temp, top_p=top_p, eos_id=3,
                      generator=torch.Generator().manual_seed(61))
    assert len(set(calls)) <= 2, set(calls)
