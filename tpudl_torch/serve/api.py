"""Request-level serving API: ``Request`` in, ``Result`` out.

The port's counterpart of tpudl.serve.api: live-model sessions over the
dense cache, the paged cache, and the paged cache with many LoRA
tenants (``adapters=``):

    session = ServeSession.from_model(model, params, prompt_len=64)
    session.submit(Request("r0", prompt_ids, max_new_tokens=32))
    results = session.collect()          # {"r0": Result(tokens=[...])}

Admission errors (prompt longer than the prompt window, or prompt window
+ max_new_tokens overflowing the KV-cache bound) raise at ``submit`` — a
request that can NEVER be seated is a caller bug, not load. Overload is
data, not an exception: a full queue or a missed deadline produces a
``Result`` with finish_reason ``shed_capacity`` / ``shed_timeout``.

Knobs: ``TPUDL_SERVE_SLOTS`` (default slot count for ``from_model``),
``TPUDL_SERVE_QUEUE_DEPTH`` (admission queue capacity),
``TPUDL_SERVE_PAGED`` and ``TPUDL_SERVE_PAGE_SIZE`` (the paged cache),
``TPUDL_SERVE_LORA_RANK``, ``TPUDL_SERVE_LORA_PAGES`` and
``TPUDL_SERVE_LORA_DTYPE`` (the adapter pool), ``TPUDL_SERVE_WEIGHT_DTYPE``
(quantized projection weights, tpudl_torch.quant), ``TPUDL_SERVE_KV_DTYPE``
(int8 KV pages), ``TPUDL_SERVE_PREFIX_SHARE`` (the radix prefix cache)
and ``TPUDL_SERVE_SPEC_K`` (speculative decoding). Artifact sessions
(``from_artifacts``) serve
the prefill and decode programs tpudl_torch.export.decode exports, with
every shape read back from the programs.

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


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` drives the per-request sampling
    stream (token t draws from a generator seeded by (seed, t)), so a
    sampled request reproduces its tokens regardless of batch
    composition; ``temperature=0`` is greedy argmax, identical to
    ``generate()``. ``deadline_s`` is relative seconds from submit — a
    request not SEATED by then is shed (running requests are never
    aborted). ``tenant`` picks the LoRA adapter a multi-tenant session
    applies (None = the plain base model). ``session_key`` is tpudl's
    sticky-placement key: it rides migration payloads (either package's),
    and the router that reads it is ROADMAP queue A item 16(c)."""

    request_id: Any
    input_ids: Sequence[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    seed: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    session_key: Optional[Any] = None
    tenant: Optional[Any] = None


@dataclasses.dataclass
class Result:
    """Outcome of one request. ``tokens`` are the generated ids,
    INCLUDING the eos that ended generation. finish_reason: ``eos`` |
    ``length`` | ``shed_timeout`` | ``shed_capacity`` | ``shed_slo`` (an
    attached SLO objective was burning) | ``failed: ...`` (a migration
    payload that could not be resumed: never resumed silently)."""

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
        slo=None,
        cache: Optional[SlotCache] = None,
        chunk_prefill_call: Optional[Callable] = None,
        speculator=None,
        verify_call: Optional[Callable] = None,
        adapter_pool=None,
    ):
        # Deferred import: engine imports Request/Result from this module.
        from tpudl_torch.obs import exporter as obs_exporter
        from tpudl_torch.serve.engine import Engine

        # Live telemetry: with TPUDL_OBS_PORT set the process serves
        # /metrics, /healthz (the engine's slots and queue, SLO burn
        # state) and /snapshot while it runs.
        obs_exporter.maybe_start_from_env()
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
            chunk_prefill_call=chunk_prefill_call, speculator=speculator,
            verify_call=verify_call, adapter_pool=adapter_pool,
        )
        if slo is not None:
            # A tpudl_torch.obs.slo.SloMonitor: the engine feeds it TTFT,
            # TPOT and queue wait and sheds while objectives burn;
            # /healthz flips 503 with the burning objective named.
            self.engine.attach_slo(slo)
            slo.register_as_health_source()
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
        paged: Optional[bool] = None,
        page_size: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        num_pages: Optional[int] = None,
        weight_dtype: Optional[str] = None,
        prefix_share: Optional[bool] = None,
        spec_k: Optional[int] = None,
        draft_weight_dtype: str = "int8",
        draft_model=None,
        draft_params=None,
        adapters: Optional[Dict[Any, Any]] = None,
        adapter_rank_max: Optional[int] = None,
        adapter_pages: Optional[int] = None,
        adapter_dtype: Optional[str] = None,
        adapter_alpha: float = 16.0,
        adapter_impl: str = "auto",
        capture: Optional[bool] = None,
        **kwargs,
    ) -> "ServeSession":
        """Live-model session over a LlamaForCausalLM and its state_dict:
        the batch-1 prefill and the ``num_slots``-batched decode
        contracts over a zeroed cache on the params' device.

        ``paged=True`` (or ``TPUDL_SERVE_PAGED=1``) swaps the dense
        fixed-slot cache for the paged layout (per-slot page tables, no
        shared write horizon, so no rollovers); ``page_size``
        (``TPUDL_SERVE_PAGE_SIZE``, default 16) and ``num_pages``
        (default: capacity parity with the dense cache) size the pool.

        ``adapters={tenant: lora_tree}`` turns on multi-tenant adapter
        serving (tpudl_torch.serve.lora): the base model stays resident
        once while every tenant's LoRA factors live in paged pools —
        loaded lazily, evicted LRU at refcount 0 under pressure, reloaded
        transparently — and each call applies every slot's own adapter
        through ONE segmented-LoRA call per projection site
        (tpudl_torch.ops.segmented_lora). ``Request.tenant`` picks the
        adapter (None = the plain base). It turns ``paged`` on.
        ``adapter_rank_max`` (``TPUDL_SERVE_LORA_RANK``; default the
        largest registered rank) bounds per-tenant rank,
        ``adapter_pages`` (``TPUDL_SERVE_LORA_PAGES``) sizes the pool,
        ``adapter_dtype="int8"`` (``TPUDL_SERVE_LORA_DTYPE``) stores
        pages quantized with per-page dequant scales, ``adapter_alpha``
        is every adapter's alpha and ``adapter_impl`` the segmented
        kernel's dispatch seam. Parity contract:
        ``tpudl_torch.serve.lora.assert_tenant_parity``.

        ``weight_dtype="int8"`` / ``"fp8_e4m3"`` (or
        ``TPUDL_SERVE_WEIGHT_DTYPE``) serves a quantized weight tree
        (tpudl_torch.quant.quantize_model: the attention and MLP
        projections stored low precision, their product the hand-written
        weight-only kernel with the scale after the contraction; norms,
        embeddings and the head full precision); already-quantized
        params pass through. It composes with ``adapters`` (the adapters
        ride outside the base projections) and with ``kv_dtype``.
        ``kv_dtype="int8"`` (or ``TPUDL_SERVE_KV_DTYPE=int8``; requires
        ``paged``) stores the KV pages int8 with per-(page, row, head) f32
        scales, quantized on the write and dequantized in the gather.

        ``capture`` (default: on when the params live on the card) makes
        the prefill and the decode call CUDA graphs
        (tpudl_torch.graphs.CapturedCall, with the greedy selection in
        the graph): each one's first call runs eagerly, its second
        captures, and every later call copies its tokens (a prefill: the
        left-padded prompt and mask, every prompt has the session's
        ``[1, prompt_len]`` shape), positions, page table and adapter
        table into the graph's buffers and replays. The engine reads a
        prefill's first token and copies its row cache into the slot
        before the next prefill replays. ``capture=False`` keeps both
        eager.

        ``prefix_share=True`` (or ``TPUDL_SERVE_PREFIX_SHARE=1``; requires
        ``paged``) turns on the radix prefix cache: seating walks a tree of
        page-granular token-block hashes, maps every matched full page
        into the new slot's table copy-on-write for free, and prefills
        only the unshared suffix through the chunked prefill
        (``chunk_prefill_fn``; on the card a graph a suffix length,
        tpudl_torch.graphs.KeyedCapturedCall, over the gathered prefix
        rows, one graph for every match length): a shared system prompt
        is prefilled once, then TTFT is O(unshared suffix).

        ``spec_k=K`` (or ``TPUDL_SERVE_SPEC_K``; requires ``paged``) turns
        on speculative decoding (tpudl_torch.serve.speculate): a DRAFT
        path proposes K tokens a slot (default: the self-draft
        ``quantize_model`` builds at ``draft_weight_dtype``; pass
        ``draft_model`` / ``draft_params`` for a companion model, its own
        cache template) with its own paged cache, and the target verifies
        the window in one slot-batched chunk call
        (``paged_chunk_decode_fn``; captured at [num_slots, K] on the
        card). Greedy requests are held by ``assert_serving_parity``'s
        teacher-forced margin mode. The two compose.

        ``prefix_share`` and ``spec_k`` with adapters, or without
        ``paged``, raise ValueError, as tpudl's do."""
        from tpudl_torch.models.generate import (
            chunk_prefill_fn,
            decode_fn,
            lora_paged_decode_fn,
            lora_prefill_fn,
            paged_chunk_decode_fn,
            paged_decode_fn,
            prefill_fn,
        )
        from tpudl_torch.models.llama import init_cache, params_device

        if weight_dtype is None:
            weight_dtype = env_str("TPUDL_SERVE_WEIGHT_DTYPE")
        if weight_dtype is not None:
            from tpudl_torch.quant import quantize_model

            model, params = quantize_model(model, params, weight_dtype)
        num_slots = (
            num_slots
            if num_slots is not None
            else env_int("TPUDL_SERVE_SLOTS", 4, min_value=1)
        )
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if paged is None:
            paged = env_flag("TPUDL_SERVE_PAGED")
        if kv_dtype is None:
            kv_dtype = env_str("TPUDL_SERVE_KV_DTYPE")
        if prefix_share is None:
            prefix_share = env_flag("TPUDL_SERVE_PREFIX_SHARE")
        if spec_k is None:
            spec_k = env_int("TPUDL_SERVE_SPEC_K")
            if spec_k == 0:
                spec_k = None
        if adapters is not None:
            if not adapters:
                raise ValueError("adapters={} registers no tenants — pass "
                                 "None to serve the plain base model")
            # Adapter serving rides the paged substrate; a dense request
            # for it is a configuration error, not a silent downgrade.
            paged = True
            if prefix_share:
                raise ValueError(
                    "prefix_share cannot compose with per-tenant adapters: "
                    "k/v projections are tenant-adapted, so identical "
                    "prompt tokens produce DIFFERENT KV per tenant — a "
                    "shared page would be wrong for one of them")
            if spec_k:
                raise ValueError("spec_k cannot compose with per-tenant "
                                 "adapters yet (the draft path has no "
                                 "adapter view)")
        device = params_device(params)
        if capture is None:
            capture = device.type == "cuda"
        if capture and device.type != "cuda":
            raise ValueError(f"capture=True needs the params on the card, "
                             f"they are on {device}")

        def captured(fn):
            if not capture:
                return fn
            from tpudl_torch.graphs import CapturedCall

            return CapturedCall(fn)

        template = init_cache(model.cfg, num_slots, device="meta")
        prefill = captured(prefill_fn(model))
        if not paged:
            if page_size is not None or num_pages is not None or \
                    kv_dtype is not None:
                raise ValueError(
                    "page_size/kv_dtype/num_pages require paged=True")
            if prefix_share or spec_k:
                raise ValueError(
                    "prefix_share/spec_k require paged=True (per-slot page "
                    "tables are what make copy-on-write sharing and window "
                    "rollback possible)")
            cache = SlotCache(template, device=device)
            return cls(prefill, captured(decode_fn(model)), params, template,
                       prompt_len, cache=cache, **kwargs)
        from tpudl_torch.serve.cache import PagedKVCache

        cache = PagedKVCache(
            template,
            page_size=(page_size if page_size is not None
                       else env_int("TPUDL_SERVE_PAGE_SIZE", 16, min_value=1)),
            num_pages=num_pages, kv_dtype=kv_dtype,
            prefix_share=bool(prefix_share), device=device, capture=capture)
        if adapters is None:
            if prefix_share:
                chunk = chunk_prefill_fn(model)
                if capture:
                    from tpudl_torch.graphs import KeyedCapturedCall

                    # One graph a suffix length (no padding: it would
                    # move the positions).
                    chunk = KeyedCapturedCall(
                        chunk, lambda params, rows, tokens, positions:
                        tuple(np.shape(tokens)))
                kwargs["chunk_prefill_call"] = chunk
            if spec_k:
                kwargs["speculator"] = _speculator(
                    model, params, spec_k, draft_weight_dtype, draft_model,
                    draft_params, num_slots, cache, num_pages, device,
                    captured)
                kwargs["verify_call"] = captured(paged_chunk_decode_fn(
                    model, cache.page_size, cache.quantized))
            return cls(prefill,
                       captured(paged_decode_fn(model, cache.page_size,
                                                cache.quantized)),
                       params, template, prompt_len, cache=cache, **kwargs)
        from tpudl_torch.models.lora import as_flat_adapters
        from tpudl_torch.serve.lora import AdapterPool

        if adapter_rank_max is None:
            adapter_rank_max = env_int("TPUDL_SERVE_LORA_RANK")
        if adapter_pages is None:
            adapter_pages = env_int("TPUDL_SERVE_LORA_PAGES")
        if adapter_dtype is None:
            adapter_dtype = env_str("TPUDL_SERVE_LORA_DTYPE")
        if adapter_rank_max is None:
            # Default rank budget: the largest registered adapter (ranks
            # validate again at register).
            ranks = [int(f["lora_a"].shape[-1])
                     for tree in adapters.values()
                     for f in as_flat_adapters(tree).values()]
            if not ranks:
                raise ValueError("no lora_a/lora_b leaves in any adapter")
            adapter_rank_max = max(ranks)
        pool = AdapterPool(model.cfg, r_max=adapter_rank_max,
                           num_slots=num_slots, num_pages=adapter_pages,
                           dtype=adapter_dtype, device=device)
        for tenant, tree in adapters.items():
            pool.register(tenant, tree, alpha=adapter_alpha)
        return cls(
            captured(lora_prefill_fn(model, impl=adapter_impl)),
            captured(lora_paged_decode_fn(model, cache.page_size,
                                          cache.quantized,
                                          impl=adapter_impl)),
            params, template, prompt_len, cache=cache, adapter_pool=pool,
            **kwargs)

    @classmethod
    def from_artifacts(
        cls,
        prefill_blob_or_path,
        decode_blob_or_path,
        params,
        paged: Optional[bool] = None,
        capture: Optional[bool] = None,
        **kwargs,
    ) -> "ServeSession":
        """Artifact session: every engine shape is recovered from the
        loaded programs (tpudl_torch.export.decode) — the slot count and
        the cache bound from the decode program's inputs, the prompt
        window from the prefill's — read from their input placeholders,
        with no side-channel metadata.

        A PAGED decode artifact (``export_serving_decoder(...,
        paged=True)``) is recognised by its addressing inputs (page
        table, start, lens); page size and pool size come from its
        page-pool inputs, the model's bound from the prefill's row cache.
        ``paged`` (optional) asserts the expectation: a mismatch raises
        instead of serving the wrong layout. ``params`` must hold the
        artifacts' keys (in any order); another key set raises, naming
        the first key that differs. ``capture`` (default: on when the
        params live on the card) wraps the loaded prefill and decode in
        CapturedCall, as ``from_model`` wraps its contracts."""
        from tpudl_torch.export.decode import artifact_call
        from tpudl_torch.export.export import input_values, load_exported_obj
        from tpudl_torch.models.llama import params_device

        pre = load_exported_obj(prefill_blob_or_path)
        dec = load_exported_obj(decode_blob_or_path)
        (pre_args, _) = input_values(pre)
        (dec_args, _) = input_values(dec)
        params = _params_in_order(params, pre_args[0], "prefill")
        _params_in_order(params, dec_args[0], "decode")
        is_paged = len(dec_args) == 7
        if len(pre_args) != 3 or len(dec_args) not in (4, 7):
            raise ValueError(
                f"not a serving artifact pair: the prefill takes "
                f"{len(pre_args)} inputs (expected 3), the decode "
                f"{len(dec_args)} (expected 4, or 7 when paged)")
        if paged is not None and bool(paged) != is_paged:
            raise ValueError(
                f"decode artifact is {'paged' if is_paged else 'dense'} "
                f"but paged={paged} was requested")
        ids = pre_args[1]
        if ids.shape[0] != 1:
            raise ValueError(
                f"serving prefill artifact must be batch-1 (one request "
                f"seated at a time), got batch {ids.shape[0]} — export "
                f"with tpudl_torch.export.decode.export_serving_decoder")
        prompt_len = int(ids.shape[1])
        device = params_device(params)
        if capture is None:
            capture = device.type == "cuda"
        token = dec_args[2]
        num_slots = int(token.shape[0])
        # The prefill's row cache ([1, max_seq_len, ...]) at num_slots.
        template = _dense_template(pre, num_slots)
        cache = None
        if is_paged:
            from tpudl_torch.serve.cache import PagedKVCache

            pool = dec_args[1]["model"]["layer_0"]["attention"]
            if "pages_k" not in pool:
                raise ValueError("paged decode artifact carries no page-pool "
                                 "cache (no pages_k input)")
            table = dec_args[4]
            cache = PagedKVCache(template,
                                 page_size=int(pool["pages_k"].shape[1]),
                                 num_pages=int(pool["pages_k"].shape[0]),
                                 kv_dtype="int8" if "scale_k" in pool
                                 else None,
                                 device=device)
            if cache.pages_per_slot != int(table.shape[1]):
                raise ValueError(
                    f"the page table spans {int(table.shape[1])} pages a "
                    f"slot, the model bound {cache.model_seq_len} at page "
                    f"size {cache.page_size} needs {cache.pages_per_slot}")
        else:
            cache = SlotCache(template, device=device)

        def wrap(program, static_args, cache_arg):
            fn = artifact_call(program, static_args, cache_arg, device)
            if not capture:
                return fn
            from tpudl_torch.graphs import CapturedCall

            return CapturedCall(fn)

        session = cls(wrap(pre, (0,), None), wrap(dec, (0, 1), 1), params,
                      template, prompt_len, cache=cache, **kwargs)
        if session.num_slots != num_slots:
            raise ValueError(
                "decode artifact's cache and token batch dims disagree")
        return session

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
        if request.tenant is not None:
            pool = self.engine.adapter_pool
            if pool is None:
                raise ValueError(
                    f"request {rid!r} names tenant {request.tenant!r} but "
                    f"this session serves no adapters (build it with "
                    f"ServeSession.from_model(adapters=...))")
            if not pool.knows(request.tenant):
                raise ValueError(
                    f"unknown tenant {request.tenant!r} — register its "
                    f"adapter before submitting (known: "
                    f"{sorted(map(str, pool.tenants))})")
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


def _speculator(model, params, spec_k, draft_weight_dtype, draft_model,
                draft_params, num_slots, cache, num_pages, device, captured):
    """``from_model``'s draft half: the int8 (``draft_weight_dtype``)
    self-draft by default, else ``draft_model`` / ``draft_params``; its
    own paged cache (page size and pool size of the target's, its own
    template: a companion's KV geometry need not match the target's,
    only the tokenizer must) and its prefill and paged decode contracts,
    wrapped by ``captured``."""
    from tpudl_torch.models.generate import paged_decode_fn, prefill_fn
    from tpudl_torch.models.llama import init_cache
    from tpudl_torch.quant import quantize_model, weight_bytes_report
    from tpudl_torch.serve.cache import PagedKVCache
    from tpudl_torch.serve.speculate import Speculator

    if draft_model is None:
        # Quantized SELF-draft: same architecture, low-precision weights;
        # agrees with the target on most greedy tokens at a fraction of
        # the bytes a call.
        draft_model, draft_params = quantize_model(model, params,
                                                   draft_weight_dtype)
    elif draft_params is None:
        raise ValueError("draft_model needs draft_params")
    draft_cache = PagedKVCache(
        init_cache(draft_model.cfg, num_slots, device="meta"),
        page_size=cache.page_size, num_pages=num_pages, device=device)
    return Speculator(
        captured(prefill_fn(draft_model)),
        captured(paged_decode_fn(draft_model, draft_cache.page_size, False)),
        draft_params, draft_cache, k=spec_k,
        weight_bytes=weight_bytes_report(draft_params)["total_bytes"])


def _params_in_order(params, spec, which: str):
    """``params`` in the key order the artifact's input spec fixed; a
    dict of other keys raises, naming the first key that differs."""
    want = list(spec)
    if list(params) == want:
        return params
    if set(params) != set(want):
        first = next((k for k in want if k not in params), None)
        if first is None:
            first = next(k for k in params if k not in spec)
        raise ValueError(
            f"params do not match the {which} artifact's parameters (first "
            f"key that differs: {first!r}; {len(params)} keys against "
            f"{len(want)})")
    return {k: params[k] for k in want}


def _dense_template(prefill_program, num_slots: int) -> dict:
    """A meta cache template of ``num_slots`` rows (init_cache's layout,
    host write index 0) from a batch-1 prefill program's row-cache
    outputs."""
    from torch.utils import _pytree

    values = {n.name: n.meta.get("val") for n in prefill_program.graph.nodes}
    leaves = []
    for spec in prefill_program.graph_signature.output_specs:
        if spec.kind.name != "USER_OUTPUT":
            continue
        arg = spec.arg
        leaves.append(values[arg.name] if hasattr(arg, "name") and arg.name
                      in values else getattr(arg, "value", None))
    _, cache = _pytree.tree_unflatten(leaves,
                                      prefill_program.call_spec.out_spec)

    def meta(leaf):
        if isinstance(leaf, torch.Tensor):
            return torch.empty((num_slots, *leaf.shape[1:]), dtype=leaf.dtype,
                               device="meta")
        return 0

    return _pytree.tree_map(meta, cache)


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
