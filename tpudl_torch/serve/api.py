"""Request-level serving API: ``Request`` in, ``Result`` out.

The port's counterpart of tpudl.serve.api, dense live-model sessions:

    session = ServeSession.from_model(model, params, prompt_len=64)
    session.submit(Request("r0", prompt_ids, max_new_tokens=32))
    results = session.collect()          # {"r0": Result(tokens=[...])}

Admission errors (prompt longer than the prompt window, or prompt window
+ max_new_tokens overflowing the KV-cache bound) raise at ``submit`` — a
request that can NEVER be seated is a caller bug, not load. Overload is
data, not an exception: a full queue or a missed deadline produces a
``Result`` with finish_reason ``shed_capacity`` / ``shed_timeout``.

Knobs: ``TPUDL_SERVE_SLOTS`` (default slot count for ``from_model``) and
``TPUDL_SERVE_QUEUE_DEPTH`` (admission queue capacity). The knobs of the
tiers not ported yet (``TPUDL_SERVE_PAGED``, ``TPUDL_SERVE_PREFIX_SHARE``,
``TPUDL_SERVE_SPEC_K``, ``TPUDL_SERVE_WEIGHT_DTYPE``) are refused when
switched on, rather than served densely behind the operator's back. Artifact sessions
(``from_artifacts``) wait for the export slice.

Streaming: ``session.stream(requests)`` yields ``StreamChunk``s as
tokens are selected; a request's concatenated chunk tokens equal the
``Result.tokens`` submit/collect returns.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpudl_torch.analysis.registry import env_flag, env_int, env_str
from tpudl_torch.obs import registry
from tpudl_torch.obs.spans import active_recorder
from tpudl_torch.serve.cache import SlotCache
from tpudl_torch.serve.queue import CAT_SERVE_REQUEST, AdmissionQueue


def _unported_tiers_requested() -> List[str]:
    """The serving-tier knobs that are switched on but not ported yet."""
    return [
        name for name, on in (
            ("TPUDL_SERVE_PAGED", env_flag("TPUDL_SERVE_PAGED")),
            ("TPUDL_SERVE_PREFIX_SHARE", env_flag("TPUDL_SERVE_PREFIX_SHARE")),
            ("TPUDL_SERVE_SPEC_K", bool(env_int("TPUDL_SERVE_SPEC_K"))),
            ("TPUDL_SERVE_WEIGHT_DTYPE",
             env_str("TPUDL_SERVE_WEIGHT_DTYPE") is not None),
        ) if on
    ]


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` drives the per-request sampling
    stream (token t draws from a generator seeded by (seed, t)), so a
    sampled request reproduces its tokens regardless of batch
    composition; ``temperature=0`` is greedy argmax, identical to
    ``generate()``. ``deadline_s`` is relative seconds from submit — a
    request not SEATED by then is shed (running requests are never
    aborted). tpudl's ``session_key`` and ``tenant`` fields wait for the
    router and adapter serving that read them."""

    request_id: Any
    input_ids: Sequence[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Result:
    """Outcome of one request. ``tokens`` are the generated ids,
    INCLUDING the eos that ended generation. finish_reason: ``eos`` |
    ``length`` | ``shed_timeout`` | ``shed_capacity``."""

    request_id: Any
    tokens: List[int]
    finish_reason: str
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    queue_wait_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.finish_reason in ("eos", "length")


@dataclasses.dataclass
class StreamChunk:
    """One increment of a streamed request: ``tokens`` selected since
    the previous chunk. The last chunk has ``done=True`` and carries the
    final ``Result``. Shed requests stream a single empty ``done``
    chunk."""

    request_id: Any
    tokens: List[int]
    done: bool
    result: Optional[Result] = None


def validate_request(request: Request, prompt_len: int, max_seq_len: int) -> None:
    """Admission validation: raise ValueError for a request that can
    never be served at the session's shapes."""
    n = len(request.input_ids)
    if n < 1:
        raise ValueError("input_ids must hold at least one token")
    if n > prompt_len:
        raise ValueError(
            f"prompt length {n} exceeds the session's compiled "
            f"prompt window {prompt_len} (rejected at admission)"
        )
    if request.max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {request.max_new_tokens}"
        )
    if prompt_len + request.max_new_tokens > max_seq_len:
        raise ValueError(
            f"prompt window ({prompt_len}) + max_new_tokens "
            f"({request.max_new_tokens}) exceeds max_seq_len "
            f"{max_seq_len} (the KV-cache bound) — rejected at "
            f"admission"
        )
    if request.temperature < 0.0:
        raise ValueError(
            f"temperature must be >= 0, got {request.temperature}"
        )
    if not 0 <= request.seed < 2**32:
        raise ValueError(
            f"seed must fit uint32 [0, 2**32), got {request.seed}"
        )


class ServeSession:
    """Synchronous submit()/collect() serving over the slot engine."""

    def __init__(
        self,
        prefill_call: Callable,
        decode_call: Callable,
        params: Any,
        cache_template: Any,
        prompt_len: int,
        queue_capacity: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        continuous: bool = True,
        cache: Optional[SlotCache] = None,
    ):
        # Deferred import: engine imports Request/Result from this module.
        from tpudl_torch.serve.engine import Engine

        if cache is None:
            cache = SlotCache(cache_template)
        self.queue = AdmissionQueue(
            capacity=queue_capacity
            if queue_capacity is not None
            else env_int("TPUDL_SERVE_QUEUE_DEPTH", 256, min_value=1),
            clock=clock,
        )
        self.engine = Engine(
            prefill_call, decode_call, params, cache, self.queue,
            prompt_len, clock=clock, continuous=continuous,
        )
        self._pending_ids: set = set()
        #: Weakref to the live stream() generator (see stream()).
        self._stream_gen = None

    # -- constructors --------------------------------------------------

    @classmethod
    def from_model(
        cls,
        model,
        params,
        prompt_len: int,
        num_slots: Optional[int] = None,
        **kwargs,
    ) -> "ServeSession":
        """Live-model session over a LlamaForCausalLM and its state_dict:
        the batch-1 prefill and the ``num_slots``-batched decode
        contracts, and a zeroed dense cache on the params' device."""
        from tpudl_torch.models.generate import decode_fn, prefill_fn
        from tpudl_torch.models.llama import init_cache, params_device

        unported = _unported_tiers_requested()
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)} switched on, but tpudl_torch serves "
                f"the dense cache only (the paged/radix caches, "
                f"speculation and weight quantization are not ported yet)"
            )
        num_slots = (
            num_slots
            if num_slots is not None
            else env_int("TPUDL_SERVE_SLOTS", 4, min_value=1)
        )
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        template = init_cache(model.cfg, num_slots, device="meta")
        cache = SlotCache(template, device=params_device(params))
        return cls(
            prefill_fn(model), decode_fn(model), params, template,
            prompt_len, cache=cache, **kwargs,
        )

    # -- introspection -------------------------------------------------

    @property
    def num_slots(self) -> int:
        return self.engine.num_slots

    @property
    def prompt_len(self) -> int:
        return self.engine.prompt_len

    @property
    def max_seq_len(self) -> int:
        return self.engine.max_seq_len

    # -- the request lifecycle -----------------------------------------

    def submit(self, request: Request) -> Any:
        """Admit one request. Raises ValueError for requests that can
        never be served at this session's shapes; records a
        ``shed_capacity`` Result when the queue is full. Returns the
        request_id either way."""
        rid = request.request_id
        if rid in self._pending_ids or rid in self.engine.results:
            raise ValueError(f"duplicate request_id {rid!r}")
        validate_request(request, self.prompt_len, self.max_seq_len)
        self._pending_ids.add(rid)
        admitted = self.queue.push(
            request, priority=request.priority, deadline_s=request.deadline_s
        )
        if not admitted:
            self.engine.results[rid] = Result(
                request_id=rid, tokens=[], finish_reason="shed_capacity",
                queue_wait_s=0.0,
            )
            registry().counter("serve_requests_shed_capacity").inc()
            rec = active_recorder()
            if rec is not None:
                rec.event(
                    "request_complete", CAT_SERVE_REQUEST, request_id=rid,
                    finish_reason="shed_capacity", queue_wait_s=0.0,
                    num_tokens=0,
                )
        return rid

    def collect(self) -> Dict[Any, Result]:
        """Run the engine until every submitted request has a Result,
        then hand them over (and flush a counters snapshot onto the
        active obs stream, if recording)."""
        self.engine.run_until_drained()
        out = {
            rid: self.engine.results.pop(rid) for rid in self._pending_ids
        }
        self._pending_ids.clear()
        # collect() finishes work an abandoned stream() admitted; release
        # its token feed here.
        self.engine.on_token = None
        rec = active_recorder()
        if rec is not None:
            rec.counters(registry().snapshot())
        return out

    def serve(self, requests: Sequence[Request]) -> Dict[Any, Result]:
        """submit() them all, collect() once — the closed-loop shape."""
        for request in requests:
            self.submit(request)
        return self.collect()

    def stream(
        self,
        requests: Sequence[Request] = (),
        chunk_tokens: int = 1,
    ):
        """Incremental serving: submit ``requests`` and yield
        ``StreamChunk``s as tokens are selected, interleaved across every
        in-flight request, until all pending requests have completed.
        Validation, submission and claiming the engine's token feed
        happen HERE at call time; only token delivery is lazy."""
        if chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {chunk_tokens}"
            )
        if self.engine.on_token is not None:
            prior = self._stream_gen() if self._stream_gen else None
            if prior is None or prior.gi_frame is None:
                # The feed belongs to a stream() generator that can never
                # release it (collected, or closed before its first
                # iteration): reclaim it.
                self.engine.on_token = None
            else:
                raise RuntimeError(
                    "a stream() is already active on this session"
                )
        buf: Dict[Any, List[int]] = {}

        def sink(rid, token):
            buf.setdefault(rid, []).append(token)

        self.engine.on_token = sink
        try:
            for request in requests:
                self.submit(request)
        except BaseException:
            self.engine.on_token = None
            raise
        gen = self._stream_chunks(buf, chunk_tokens, sink)
        self._stream_gen = weakref.ref(gen)
        return gen

    def _stream_chunks(
        self, buf: Dict[Any, List[int]], chunk_tokens: int, sink
    ):
        """The lazy half of ``stream()``: step the engine and yield
        chunks until every pending request completes, then release the
        token feed — only while this generator still OWNS it."""
        try:
            while self._pending_ids:
                if self.engine.on_token is not sink:
                    return
                progressed = self.engine.step()
                finished = [
                    rid for rid in list(self._pending_ids)
                    if rid in self.engine.results
                ]
                for rid in finished:
                    result = self.engine.results.pop(rid)
                    self._pending_ids.discard(rid)
                    yield StreamChunk(
                        rid, buf.pop(rid, []), True, result
                    )
                for rid, toks in list(buf.items()):
                    if len(toks) >= chunk_tokens:
                        buf[rid] = []
                        yield StreamChunk(rid, toks, False, None)
                if not progressed and not finished and self._pending_ids:
                    raise RuntimeError(
                        f"engine drained with requests still pending "
                        f"(no Result for {sorted(map(str, self._pending_ids))})"
                    )
        finally:
            if self.engine.on_token is sink:
                self.engine.on_token = None
        rec = active_recorder()
        if rec is not None:
            rec.counters(registry().snapshot())


def assert_serving_parity(
    session: ServeSession,
    model,
    params,
    requests: Sequence[Request],
    atol: Optional[float] = None,
) -> None:
    """Serve ``requests`` through ``session`` and assert every GREEDY
    request's tokens match ``generate()`` on ``model``/``params`` run on
    the request alone: exactly (``atol=None``), or under the
    teacher-forced logit-margin contract (``atol`` set — see
    ``assert_tokens_match``)."""
    results = session.serve(list(requests))
    for req in requests:
        if req.temperature != 0.0:
            continue
        res = results[req.request_id]
        assert res.ok, (req.request_id, res.finish_reason)
        assert_tokens_match_generate(
            model, params, req, np.asarray(res.tokens), atol
        )


def assert_tokens_match_generate(model, params, req, got, atol) -> None:
    """The per-request half of ``assert_serving_parity``: compare one
    greedy request's engine tokens against ``generate()`` on
    ``params``."""
    from tpudl_torch.models.generate import generate

    want = generate(
        model, params, torch.as_tensor(req.input_ids)[None, :],
        max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
    )[0].cpu().numpy()
    assert_tokens_match(model, params, req, got, want, atol)


def assert_tokens_match(model, params, req, got, want, atol) -> None:
    """Compare a greedy request's tokens ``got`` with a reference
    ``want``. ``atol=None`` demands token-for-token equality (a Result
    stops at eos, the reference pads with it). With ``atol`` set, the
    two may diverge only at a genuine near-tie: at the first divergence
    the reference sequence is teacher-forced through ``model`` (its
    prefill contract; the non-decode forward is not ported) and the
    reference's choice may beat the token ``got`` holds there by a
    logit margin of at most ``atol``. After a legitimate flip the paths
    differ by design and comparison stops; a wide margin means wrong
    values, and the assert fires."""
    got = np.asarray(got)
    want = np.asarray(want)
    if atol is None:
        np.testing.assert_array_equal(
            got, want[: got.shape[0]],
            err_msg=f"request {req.request_id} diverged from the reference",
        )
        if req.eos_id is not None and got.shape[0] < want.shape[0]:
            assert np.all(want[got.shape[0]:] == req.eos_id), (
                f"request {req.request_id}: engine stopped at eos but the "
                f"reference kept producing non-eos tokens"
            )
        return
    n = min(got.shape[0], want.shape[0])
    mismatches = np.nonzero(got[:n] != want[:n])[0]
    if mismatches.size == 0:
        return
    t = int(mismatches[0])
    # Teacher-force the reference path up to the diverging step and
    # measure how contested the reference's choice actually was.
    from tpudl_torch.models.generate import prefill_fn

    prefix = np.concatenate(
        [np.asarray(req.input_ids, np.int64), want[:t].astype(np.int64)]
    )[None, :]
    last, _ = prefill_fn(model)(params, prefix, np.ones_like(prefix))
    last = last[0].float().cpu().numpy()
    margin = float(last[int(want[t])] - last[int(got[t])])
    assert margin <= atol, (
        f"request {req.request_id}: diverged from the reference at step "
        f"{t} where the reference prefers token {want[t]} over {got[t]} by "
        f"logit margin {margin:.4f} > atol={atol} — wrong values, not a "
        f"near-tie"
    )
