"""tpudl_torch.serve against tpudl.serve on the CPU.

The same tiny f32 Llama (tpudl's ``model.init`` params through
``params_from_tpudl``) serves the same ragged requests through tpudl's
``ServeSession`` and the port's: greedy tokens, finish reasons and the
engine's schedule (prefills, decode steps, rollovers) must be identical.
The port is also held to its own contracts: every greedy result equals
its ``generate()``, streaming equals collect, sampled requests do not
depend on their neighbours, and the admission queue (a copy of tpudl's)
behaves like tpudl's in every scenario of tests/test_serve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.models.llama import LLAMA_TINY as J_TINY
from tpudl.models.llama import LlamaForCausalLM as JLlama
from tpudl.serve import AdmissionQueue as JQueue
from tpudl.serve import Request as JRequest
from tpudl.serve import ServeSession as JSession
from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, params_from_tpudl
from tpudl_torch.serve import AdmissionQueue, Request, ServeSession, SlotCache
from tpudl_torch.serve.api import assert_serving_parity

PROMPT_LEN = 8
SLOTS = 4


def _pair(max_seq_len):
    """(tpudl model, tpudl params, port model, port params), f32."""
    jmodel = JLlama(J_TINY(dtype=jnp.float32, max_seq_len=max_seq_len))
    jparams = jmodel.init(
        jax.random.key(0), jnp.zeros((1, PROMPT_LEN), jnp.int32)
    )["params"]
    tmodel = LlamaForCausalLM(
        LLAMA_TINY(dtype=torch.float32, max_seq_len=max_seq_len),
        device="meta")
    tparams = params_from_tpudl(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair(96)


def _ragged(n, seed, cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [
        cls(
            request_id=f"r{i}",
            input_ids=rng.integers(
                1, 512, size=int(rng.integers(2, PROMPT_LEN + 1))).tolist(),
            max_new_tokens=int(rng.integers(4, 20)),
            **kw,
        )
        for i in range(n)
    ]


def _both(pair, requests_of, **kw):
    """Serve the same requests through both packages' sessions."""
    jmodel, jparams, tmodel, tparams = pair
    kw.setdefault("prompt_len", PROMPT_LEN)
    kw.setdefault("num_slots", SLOTS)
    js = JSession.from_model(jmodel, jparams, **kw)
    ts = ServeSession.from_model(tmodel, tparams, **kw)
    return js, js.serve(requests_of(JRequest)), ts, ts.serve(requests_of(Request))


def test_ragged_greedy_serving_matches_tpudl(pair):
    js, jres, ts, tres = _both(pair, lambda cls: _ragged(8, 1, cls))
    assert set(tres) == set(jres)
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert tres[rid].finish_reason == jres[rid].finish_reason
    for attr in ("num_prefills", "num_decode_steps", "num_rollovers"):
        assert getattr(ts.engine, attr) == getattr(js.engine, attr), attr


def test_results_match_own_generate_exactly(pair):
    _, _, tmodel, tparams = pair
    session = ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                      num_slots=SLOTS)
    requests = _ragged(6, 2) + [Request("e", [5, 6, 7], max_new_tokens=12,
                                        eos_id=3)]
    assert_serving_parity(session, tmodel, tparams, requests)
    for res in session.engine.results.values():
        assert res.ttft_s >= res.queue_wait_s >= 0


def test_horizon_rollover_matches_tpudl():
    """More decode work than one cache horizon holds: both engines roll
    the cache over between waves, identically, and tokens still match."""
    pair = _pair(32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 500, size=5).tolist() for _ in range(5)]
    js, jres, ts, tres = _both(
        pair,
        lambda cls: [cls(f"r{i}", p, max_new_tokens=20)
                     for i, p in enumerate(prompts)],
        num_slots=2,
    )
    assert ts.engine.num_rollovers >= 1
    assert ts.engine.num_rollovers == js.engine.num_rollovers
    # The host-side write index stayed in lockstep with the cache's own.
    index = ts.engine.cache.cache["model"]["layer_0"]["attention"]["index"]
    assert index == ts.engine.cache.write_index
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid


def test_admission_rejects_like_tpudl(pair):
    jmodel, jparams, tmodel, tparams = pair
    js = JSession.from_model(jmodel, jparams, prompt_len=PROMPT_LEN,
                             num_slots=2)
    ts = ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                 num_slots=2)
    bad = [
        (dict(input_ids=list(range(1, PROMPT_LEN + 2)), max_new_tokens=2),
         "prompt window"),
        (dict(input_ids=[1, 2], max_new_tokens=96), "max_seq_len"),
        (dict(input_ids=[], max_new_tokens=2), "at least one token"),
        (dict(input_ids=[1], max_new_tokens=0), "max_new_tokens"),
        (dict(input_ids=[1], max_new_tokens=2, seed=-1), "uint32"),
        (dict(input_ids=[1], max_new_tokens=2, temperature=-1.0),
         "temperature"),
    ]
    for kw, match in bad:
        for session, cls in ((js, JRequest), (ts, Request)):
            with pytest.raises(ValueError, match=match):
                session.submit(cls("bad", **kw))
    ts.submit(Request("dup", [1, 2], max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        ts.submit(Request("dup", [1, 2], max_new_tokens=2))
    assert ts.collect()["dup"].ok


def test_capacity_and_deadline_shedding_match_tpudl(pair):
    t = [0.0]

    def requests(cls):
        return [cls("late", [1, 2, 3], max_new_tokens=4, deadline_s=1.0)] + [
            cls(f"q{i}", [1, 2], max_new_tokens=3) for i in range(3)
        ]

    jmodel, jparams, tmodel, tparams = pair
    reasons = []
    for session_cls, model, params, cls in (
        (JSession, jmodel, jparams, JRequest),
        (ServeSession, tmodel, tparams, Request),
    ):
        t[0] = 0.0
        session = session_cls.from_model(
            model, params, prompt_len=PROMPT_LEN, num_slots=2,
            queue_capacity=3, clock=lambda: t[0])
        for req in requests(cls):
            session.submit(req)
        t[0] = 5.0  # "late" is past its deadline before it is seated
        results = session.collect()
        reasons.append({rid: r.finish_reason for rid, r in results.items()})
    assert reasons[1] == reasons[0]
    assert reasons[1] == {"late": "shed_timeout", "q0": "length",
                          "q1": "length", "q2": "shed_capacity"}


def test_streaming_matches_collect(pair):
    _, _, tmodel, tparams = pair
    requests = _ragged(6, 11)

    def session():
        return ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN,
                                       num_slots=SLOTS)

    ref = session().serve([Request(**r.__dict__) for r in requests])
    s = session()
    chunks, finals, count = {}, {}, {}
    for chunk in s.stream([Request(**r.__dict__) for r in requests]):
        chunks.setdefault(chunk.request_id, []).extend(chunk.tokens)
        count[chunk.request_id] = count.get(chunk.request_id, 0) + 1
        if chunk.done:
            finals[chunk.request_id] = chunk.result
    assert set(finals) == set(ref)
    for rid in ref:
        assert chunks[rid] == finals[rid].tokens == ref[rid].tokens, rid
        assert count[rid] >= 2  # delivered incrementally
    assert s.engine.on_token is None
    with pytest.raises(ValueError, match="chunk_tokens"):
        s.stream([], chunk_tokens=0)


def test_sampling_is_batch_composition_independent(pair):
    _, _, tmodel, tparams = pair

    def serve(requests):
        return ServeSession.from_model(
            tmodel, tparams, prompt_len=PROMPT_LEN, num_slots=SLOTS
        ).serve(requests)

    req = Request("s", [7, 8, 9], max_new_tokens=10, temperature=1.0, seed=42)
    alone = serve([Request(**req.__dict__)])
    crowd = serve([Request(**req.__dict__)] + _ragged(6, 6))
    assert alone["s"].tokens == crowd["s"].tokens
    other = serve([Request("s", [7, 8, 9], max_new_tokens=10,
                           temperature=1.0, seed=43)])
    assert other["s"].tokens != alone["s"].tokens


def test_unported_serving_tiers_are_refused(pair, monkeypatch):
    # The radix prefix cache and speculation are ported
    # (tests/test_torch_prefix_spec.py): their knobs switch them on, and
    # without the paged cache they are refused as tpudl refuses them.
    _, _, tmodel, tparams = pair
    monkeypatch.setenv("TPUDL_SERVE_PREFIX_SHARE", "1")
    with pytest.raises(ValueError, match="require paged"):
        ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN)
    monkeypatch.setenv("TPUDL_SERVE_PREFIX_SHARE", "0")  # off, as tpudl reads it
    assert not ServeSession.from_model(tmodel, tparams,
                                       prompt_len=PROMPT_LEN).engine.paged
    # The paged cache is ported (tests/test_torch_tenant_lora.py).
    monkeypatch.setenv("TPUDL_SERVE_PAGED", "1")
    assert ServeSession.from_model(tmodel, tparams,
                                   prompt_len=PROMPT_LEN).engine.paged
    monkeypatch.setenv("TPUDL_SERVE_PREFIX_SHARE", "1")
    monkeypatch.setenv("TPUDL_SERVE_SPEC_K", "2")
    engine = ServeSession.from_model(tmodel, tparams,
                                     prompt_len=PROMPT_LEN).engine
    assert engine.prefix_share and engine.speculator.k == 2
    monkeypatch.setenv("TPUDL_SERVE_SPEC_K", "0")  # 0 = off, as tpudl reads it
    assert ServeSession.from_model(tmodel, tparams, prompt_len=PROMPT_LEN
                                   ).engine.speculator is None


def test_slot_cache_bookkeeping():
    """tpudl's SlotCache scenario (tests/test_serve.py) on the port's
    in-place cache."""
    template = {"layer": {
        "k": torch.empty((3, 16, 2, 4), device="meta"),
        "valid": torch.empty((3, 16), dtype=torch.bool, device="meta"),
        "index": 0,
    }}
    cache = SlotCache(template, device="cpu")
    assert (cache.num_slots, cache.max_seq_len) == (3, 16)
    assert cache.write_index == 0 and cache.remaining_horizon == 16
    row = {"layer": {
        "k": torch.ones((1, 16, 2, 4)),
        "valid": torch.tensor([[True] * 5 + [False] * 11]),
        "index": 5,
    }}
    cache.insert(row, 1)
    assert cache.write_index == 0 and cache.cache["layer"]["index"] == 0
    assert torch.equal(cache.cache["layer"]["k"][1], row["layer"]["k"][0])
    np.testing.assert_array_equal(cache.valid_counts(), [0, 5, 0])
    cache.set_write_index(5)
    assert cache.cache["layer"]["index"] == 5 and cache.remaining_horizon == 11
    cache.free(1)
    np.testing.assert_array_equal(cache.valid_counts(), [0, 0, 0])
    cache.advance_write_index()
    assert cache.write_index == 6
    cache.reset()
    assert cache.write_index == 0 and cache.cache["layer"]["index"] == 0
    assert not cache.cache["layer"]["k"].any()
    assert cache.nbytes == 3 * 16 * 2 * 4 * 4 + 3 * 16
    with pytest.raises(IndexError):
        cache.insert(row, 3)
    with pytest.raises(ValueError, match="validity"):
        SlotCache({"k": torch.empty((3, 16), device="meta")})


# ---------------------------------------------------------------------------
# The admission queue: tpudl's scenarios, run against both implementations.
# ---------------------------------------------------------------------------

QUEUES = pytest.mark.parametrize("Queue", [JQueue, AdmissionQueue],
                                 ids=["tpudl", "tpudl_torch"])


class _R:
    def __init__(self, name, size=1, big=False):
        self.name, self.size, self.big = name, size, big


@QUEUES
def test_queue_priority_fifo_and_fit(Queue):
    t = [0.0]
    q = Queue(capacity=8, clock=lambda: t[0])
    assert q.push(_R("b0"), priority=1)
    assert q.push(_R("a0"), priority=0)
    assert q.push(_R("a1"), priority=0)
    assert q.push(_R("big", size=99), priority=0)
    fit = lambda r: r.size < 10  # noqa: E731
    names = [q.pop(fit=fit)[0].request.name for _ in range(3)]
    assert names == ["a0", "a1", "b0"]  # "big" skipped, still queued
    assert len(q) == 1 and q.pop()[0].request.name == "big"


@QUEUES
def test_queue_deadlines_and_capacity(Queue):
    t = [0.0]
    q = Queue(capacity=2, clock=lambda: t[0])
    assert q.push("x", deadline_s=1.0) and q.push("y")
    assert not q.push("overflow")
    t[0] = 2.0
    entry, shed = q.pop()
    assert entry.request == "y" and [e.request for e in shed] == ["x"]
    q.push("z", deadline_s=0.5)
    t[0] = 9.0
    assert [e.request for e in q.drain_expired()] == ["z"]
    assert len(q) == 0
    with pytest.raises(ValueError, match="capacity"):
        Queue(capacity=0)


@QUEUES
def test_queue_aging_promotion(Queue):
    t = [0.0]
    q = Queue(capacity=8, clock=lambda: t[0], promote_after_s=5.0)
    q.push("low", priority=9)
    q.push("hi0", priority=0)
    assert q.pop()[0].request == "hi0"
    t[0] = 6.0
    q.push("hi1", priority=0)
    assert [q.pop()[0].request for _ in range(2)] == ["low", "hi1"]
    q.push(_R("big-old", big=True), priority=9)
    t[0] += 6.0
    q.push(_R("small"), priority=0)
    assert q.pop(fit=lambda r: not r.big)[0].request.name == "small"
    q2 = Queue(capacity=8, clock=lambda: t[0], promote_after_s=None)
    q2.push("low", priority=9)
    t[0] += 1e9
    q2.push("hi", priority=0)
    assert q2.pop()[0].request == "hi"
    with pytest.raises(ValueError, match="promote_after_s"):
        Queue(promote_after_s=0)


@QUEUES
def test_queue_deadline_heap_and_drain_all(Queue):
    t = [0.0]
    q = Queue(capacity=16, clock=lambda: t[0])
    q.push("a", deadline_s=1.0)
    q.push("b", deadline_s=2.0)
    q.push("c", deadline_s=3.0)
    q.push("d")
    entry, shed = q.pop()
    assert entry.request == "a" and not shed  # popped before expiry
    t[0] = 2.5  # a is consumed, b expired: only b sheds
    entry, shed = q.pop()
    assert [e.request for e in shed] == ["b"] and entry.request == "c"
    q.push("e", priority=1, deadline_s=9.0)
    q.push("f", priority=0)
    assert [e.request for e in q.drain_all()] == ["d", "f", "e"]
    t[0] = 1e9
    assert q.drain_expired() == [] and q.pop() == (None, [])
