"""Slot-based continuous batching over the prefill and decode calls.

The port's counterpart of tpudl.serve.engine, dense path. The engine is
host orchestration around exactly two calls — the batch-1 prefill and
the slot-batched single-token decode that tpudl_torch.models.generate
defines (``(params, ids, mask) -> (logits, cache)`` and ``(params,
cache, token, position) -> (logits, cache)``). Requests are multiplexed
onto them through a fixed-slot cache:

    queue ──pop──▶ prefill(batch=1) ──insert──▶ slot i of the cache
                                                    │
                 every step: decode(batch=slots) ───┘  finished slot →
                 emit per-slot token, advance         Result out,
                 per-slot position                    refill from queue

A slot that finishes (eos / max tokens) is refilled IMMEDIATELY, while
its neighbors keep decoding (``continuous=False`` disables exactly
this refill: the run-to-completion static-batch baseline).

The one resource all slots share — in DENSE mode — is the cache WRITE
INDEX: every decode writes all rows at the same slot and advances it by
one, so the horizon ``max_seq_len - write_index`` shrinks for everyone.
The engine therefore (a) only seats a request whose max_new_tokens fits
the remaining horizon, and (b) when the batch drains with work still
queued, RESETS the cache to recover the full horizon (a "rollover").

In PAGED mode (``cache.paged``, a tpudl_torch.serve.cache.PagedKVCache)
there is no shared index: each slot carries its own length and decode
writes through a host-owned page table, so rollovers do not exist and
admission is ``fits_tokens`` (are enough free pages left to reserve the
request's worst case up front). The decode call takes three more small
inputs (``paged_decode_fn``: page table, start, lens).

With an ``adapter_pool`` (tpudl_torch.serve.lora.AdapterPool, paged mode
only) the engine serves many LoRA tenants off the one resident base: the
prefill and decode calls are the ``lora_*`` contracts (three more
inputs: the pools, the per-slot table and scale), each seated request
pins its tenant's adapter pages for the slot's lifetime, and a request
is seated only once its adapter is securable.

Sampling is per-request and batch-composition-independent: token ``t``
of a request is drawn from a ``torch.Generator`` seeded from
``(request.seed, t)`` (tpudl uses ``fold_in(key(seed), t)``, whose bits
torch cannot reproduce), so the same request yields the same tokens
whatever its neighbors are. Greedy requests match ``generate()`` token
for token.

On the card ``ServeSession.from_model`` hands the engine a captured
prefill and a captured decode call (tpudl_torch.graphs.CapturedCall):
each replays one CUDA graph a call, greedy selection included, and
leaves the argmax in ``.greedy``, which the selection reads back instead
of computing it again. The dense cache's write index is then a device
tensor the graph advances; the engine's horizon checks read its host
mirror (``SlotCache.write_index``).

With a radix cache (``cache.prefix_share``) a seat walks the prefix
tree: matched full pages map into the slot for free, and the batch-1
prefill is replaced by the CHUNKED suffix prefill over the gathered
prefix rows (``chunk_prefill_call``), so prefill cost drops from the
prompt window to the unshared suffix. With a ``speculator``
(tpudl_torch.serve.speculate) each step is a speculative window: k
draft calls propose, ONE slot-batched verify call
(``verify_call``, the paged chunk decode) scores the window, and
acceptance emits 1..k tokens a slot.

Not ported yet: migration and the disaggregation inbox (ROADMAP queue A
item 3), the SLO hook, chaos hooks, the request log and the exporter's
health source.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpudl_torch.models.generate import gumbel_argmax
from tpudl_torch.obs import registry
from tpudl_torch.obs.spans import active_recorder
from tpudl_torch.rng import fold_in
from tpudl_torch.serve.api import Request, Result
from tpudl_torch.serve.cache import SlotCache
from tpudl_torch.serve.queue import CAT_SERVE_REQUEST, AdmissionQueue, _Entry

#: Span categories (their own rows in the obs report breakdown table).
CAT_SERVE_PREFILL = "serve_prefill"
CAT_SERVE_DECODE = "serve_decode"


def _select_greedy(logits: torch.Tensor, greedy=None) -> np.ndarray:
    """Argmax selection (every active slot greedy): one f32 argmax and
    one readback. ``greedy``: the argmax a captured decode call computed
    in its graph (tpudl_torch.graphs.CapturedCall), read back as is."""
    if greedy is None:
        greedy = torch.argmax(logits.float(), dim=-1)
    return greedy.cpu().numpy()


def _select_tokens(logits, temps, seeds, steps, greedy=None) -> np.ndarray:
    """Per-slot next-token selection on [B, V] logits: greedy argmax
    where ``temps[i] == 0`` (``greedy``, when a captured call computed
    it), else a categorical draw over temperature-scaled logits from
    ``fold_in(seeds[i], steps[i])`` (a generator of its own per request
    and token, so a request's draws do not depend on its neighbours or
    on how many draws they made), eagerly. f32 selection math like
    generate._select_impl."""
    logits = logits.float()
    out = (torch.argmax(logits, dim=-1) if greedy is None
           else greedy.clone())
    for i in np.nonzero(temps > 0)[0]:
        g = fold_in(seeds[i], steps[i], logits.device)
        out[i] = gumbel_argmax(logits[i: i + 1] / float(temps[i]), g)[0]
    return out.cpu().numpy()


def first_token(logits, request, greedy=None) -> int:
    """Select a request's FIRST token from its batch-1 prefill logits
    (step 0 of its per-request sampling stream); ``greedy``: the argmax
    a captured prefill computed in its graph."""
    if request.temperature > 0:
        sel = _select_tokens(
            logits,
            np.float32([request.temperature]),
            np.uint32([request.seed]),
            np.int32([0]),
        )
    else:
        sel = _select_greedy(logits, greedy)
    return int(sel[0])


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = (
        "entry", "request", "tokens", "position", "steps",
        "t_seated", "t_first", "t_last", "adapter_reloads",
        "prefix_hit", "spec_proposed", "spec_accepted",
    )

    def __init__(self, entry: _Entry, first_token: int, prompt_len: int,
                 seated: float, now: float):
        self.entry = entry
        self.request: Request = entry.request
        self.tokens: List[int] = [first_token]
        self.position = prompt_len  # next absolute RoPE position
        self.steps = 1  # tokens drawn so far (the sampling stream index)
        self.t_seated = seated  # pop time: queue wait ends HERE
        self.t_first = now  # first token out: TTFT ends here (incl. prefill)
        self.t_last = now
        # Adapter reloads this request's seating paid for.
        self.adapter_reloads = 0
        # Prompt tokens the radix cache served; draft tokens proposed
        # and accepted (tpudl writes these into its request log).
        self.prefix_hit = 0
        self.spec_proposed = 0
        self.spec_accepted = 0


class Engine:
    """The request multiplexer. Pulls from an AdmissionQueue, keeps
    ``num_slots`` generation streams in flight, writes ``Result``s into
    ``self.results`` keyed by request_id. Synchronous: ``step()``
    advances the world by one decode step; ``run_until_drained()`` loops
    it (the ServeSession front end drives either)."""

    def __init__(
        self,
        prefill_call: Callable,
        decode_call: Callable,
        params: Any,
        cache: SlotCache,
        queue: AdmissionQueue,
        prompt_len: int,
        clock: Callable[[], float] = time.monotonic,
        continuous: bool = True,
        chunk_prefill_call: Optional[Callable] = None,
        speculator=None,
        verify_call: Optional[Callable] = None,
        adapter_pool=None,
    ):
        if prompt_len < 1 or prompt_len >= cache.max_seq_len:
            raise ValueError(
                f"prompt_len must be in [1, max_seq_len) = "
                f"[1, {cache.max_seq_len}), got {prompt_len}"
            )
        self.prefill_call = prefill_call
        self.decode_call = decode_call
        self.params = params
        self.cache = cache
        self.queue = queue
        self.prompt_len = prompt_len
        self.num_slots = cache.num_slots
        self.max_seq_len = cache.max_seq_len
        self.clock = clock
        self.continuous = continuous
        self.paged = bool(getattr(cache, "paged", False))
        # Prefix sharing (radix mode): the seat walks the radix tree, maps
        # matched full pages for free and, with the chunked prefill,
        # prefills only the unshared suffix. Without the chunk call
        # sharing still deduplicates pages; only the compute skip is lost.
        self.prefix_share = self.paged and bool(
            getattr(cache, "prefix_share", False))
        self.chunk_prefill_call = chunk_prefill_call
        # Multi-tenant LoRA serving: the prefill/decode calls are the
        # lora_* contracts and each seated request pins its tenant.
        self.adapter_pool = adapter_pool
        if adapter_pool is not None:
            if not self.paged:
                raise ValueError(
                    "multi-tenant adapters require a paged cache (the "
                    "adapter pool rides the same host-owned-table contract)")
            if self.prefix_share:
                raise ValueError(
                    "adapter serving cannot share KV prefixes across "
                    "tenants (k/v projections are tenant-adapted, so "
                    "identical tokens produce DIFFERENT pages per tenant) "
                    "— prefix_share must be off")
            if speculator is not None:
                raise ValueError(
                    "speculative decoding with per-tenant adapters is not "
                    "supported (the draft has no adapter view)")
        # Speculative decoding: draft k cheap tokens, verify them in ONE
        # slot-batched chunk call.
        self.speculator = speculator
        self.verify_call = verify_call
        if speculator is not None:
            if not self.paged:
                raise ValueError(
                    "speculative decoding requires a paged cache (per-slot "
                    "lens is what makes rollback free)")
            if verify_call is None:
                raise ValueError(
                    "speculator needs verify_call (the k-token paged chunk "
                    "decode call)")
        self._slots: List[Optional[_Slot]] = [None] * self.num_slots
        self.results: Dict[Any, Result] = {}
        # Streaming feed: called with (request_id, token) the moment a
        # token is selected (prefill's first token included) — BEFORE
        # the finish check. ServeSession.stream() installs it.
        self.on_token: Optional[Callable[[Any, int], None]] = None
        # Decode steps are the deterministic cost unit the
        # static-vs-continuous comparison uses.
        self.num_decode_steps = 0
        self.num_prefills = 0
        self.num_rollovers = 0
        registry().gauge("serve_cache_bytes").set(cache.nbytes)

    # -- admission / seating -------------------------------------------

    def _record_shed(self, entries: List[_Entry], reason: str) -> None:
        reg = registry()
        rec = active_recorder()
        now = self.clock()
        for entry in entries:
            req = entry.request
            wait = now - entry.submitted_at
            self.results[req.request_id] = Result(
                request_id=req.request_id,
                tokens=[],
                finish_reason=reason,
                queue_wait_s=wait,
            )
            reg.counter(f"serve_requests_{reason}").inc()
            if rec is not None:
                rec.event(
                    "request_complete", CAT_SERVE_REQUEST,
                    request_id=req.request_id, finish_reason=reason,
                    queue_wait_s=wait, num_tokens=0,
                )

    def _seat(self, entry: _Entry, slot: int) -> None:
        """Prefill one request, put its cache row into ``slot`` of the live
        cache, select its first token. Radix mode first walks the prefix
        tree: matched full pages seat for free, and the batch-1 prefill
        (left-padded to the prompt window) is replaced by the CHUNKED
        suffix prefill over the gathered prefix rows. With adapters, the
        tenant's pages are pinned BEFORE the prefill (loaded on demand:
        an evicted tenant reloads here); the pin and the radix lease are
        released if the prefill fails."""
        req = entry.request
        ids = np.asarray(req.input_ids, np.int32)
        rec = active_recorder()
        t0 = self.clock()
        lease = None
        hit = 0
        row_offset = self.prompt_len - int(ids.shape[0])
        greedy = None
        pool = self.adapter_pool
        reloads0 = pool.num_reloads if pool is not None else 0
        tenant_pinned = False
        try:
            if pool is not None:
                arow, ascale = pool.acquire(req.tenant)
                tenant_pinned = req.tenant is not None
            if self.prefix_share:
                lease = self.cache.match_and_lease(ids)
                # A fully matched prompt still needs its LAST token's
                # logits to select the first generated token, so the
                # compute skip caps at ids_len - 1.
                hit = min(len(lease[0]) * self.cache.page_size,
                          int(ids.shape[0]) - 1)
            if hit > 0 and self.chunk_prefill_call is not None:
                rows = self.cache.gather_prefix_rows(lease[0], hit)
                suffix = ids[hit:][None, :]
                positions = np.arange(hit, ids.shape[0],
                                      dtype=np.int32)[None, :]
                logits, row_cache = self.chunk_prefill_call(
                    self.params, rows, suffix, positions)
                greedy = getattr(self.chunk_prefill_call, "greedy", None)
                row_offset = 0  # chunk rows are already left-aligned
            else:
                hit = 0  # no chunk call: a full prefill, pages dedup only
                pad = self.prompt_len - ids.shape[0]
                padded = np.concatenate([np.zeros(pad, np.int32), ids])[None, :]
                mask = np.concatenate(
                    [np.zeros(pad, np.int32), np.ones(ids.shape[0], np.int32)]
                )[None, :]
                if pool is not None:
                    logits, row_cache = self.prefill_call(
                        self.params, padded, mask, pool.pools, arow[None, :],
                        np.float32([ascale]))
                else:
                    logits, row_cache = self.prefill_call(self.params, padded,
                                                          mask)
                greedy = getattr(self.prefill_call, "greedy", None)
            # A captured prefill's logits, argmax and row cache are its
            # graph's buffers: the token is read here and _install copies
            # the row into the slot, both before the next prefill replays.
            first = first_token(logits, req, greedy)
        except BaseException:
            if lease is not None:
                self.cache.release_lease(lease[1])
            if tenant_pinned:
                pool.release(req.tenant)
            raise
        now = self.clock()
        if rec is not None:
            # prefix_hit_tokens: how much of the prompt the radix cache
            # paid for (the TTFT attribution).
            rec.record("prefill", CAT_SERVE_PREFILL, t0, now - t0,
                       {"slot": slot, "request_id": req.request_id,
                        "queue_wait_s": t0 - entry.submitted_at,
                        "prefix_hit_tokens": hit})
        if hit:
            registry().counter("serve_prefix_hit_tokens").inc(hit)
        self.num_prefills += 1
        registry().counter("serve_prefills").inc()
        self._install(entry, slot, row_cache, first, ids.shape[0], t0, now,
                      pool.num_reloads - reloads0 if pool is not None else 0,
                      lease=lease, row_offset=row_offset, prefix_hit=hit)

    def _install(self, entry: _Entry, slot: int, row_cache: Any,
                 first: int, ids_len: int, t_popped: float,
                 t_first: float, adapter_reloads: int = 0, lease=None,
                 row_offset: int = 0, prefix_hit: int = 0) -> None:
        """Seat tail: cache insertion (dense copy, paged reservation and
        scatter, or radix-shared left-aligned seat), the draft cache's
        seat, adapter binding (the seat's pin moves to the slot), latency
        accounting, slot activation."""
        req = entry.request
        tenant = req.tenant
        try:
            if self.prefix_share:
                self.cache.seat_shared(
                    row_cache, slot, req.input_ids,
                    ids_len + req.max_new_tokens, lease=lease,
                    row_offset=row_offset)
            elif self.paged:
                self.cache.seat(
                    row_cache, slot, self.prompt_len - ids_len,
                    self.prompt_len, self.prompt_len + req.max_new_tokens)
            else:
                self.cache.insert(row_cache, slot)
        except BaseException:
            # The slot was never bound, so free_slot will never release
            # the seat's pin: without this the pages stay unevictable.
            if self.adapter_pool is not None:
                self.adapter_pool.release(tenant)
            raise
        if self.adapter_pool is not None:
            self.adapter_pool.bind_slot(slot, tenant)
        if self.speculator is not None:
            self.speculator.seat(
                slot, np.asarray(req.input_ids, np.int32), self.prompt_len,
                self.prompt_len + req.max_new_tokens)
        queue_wait_ms = 1e3 * (t_popped - entry.submitted_at)
        ttft_ms = 1e3 * (t_first - entry.submitted_at)
        reg = registry()
        reg.histogram("serve_queue_wait_ms").observe(queue_wait_ms)
        reg.histogram("serve_ttft_ms").observe(ttft_ms)
        s = _Slot(entry, first, ids_len, t_popped, t_first)
        s.adapter_reloads = adapter_reloads
        s.prefix_hit = prefix_hit
        self._slots[slot] = s
        if self.on_token is not None:
            self.on_token(req.request_id, first)
        # A request can finish on its very first token.
        self._maybe_finish(slot, first)

    def _active(self) -> bool:
        return any(s is not None for s in self._slots)

    def _fill_slots(self) -> None:
        """Seat queued work into empty slots. Static mode only refills
        once the WHOLE batch drained; continuous mode refills the moment
        a slot frees."""
        if not self.continuous and self._active():
            return
        if not self.paged and not self._active() and len(self.queue):
            # Batch drained with work queued: recover the full write
            # horizon before seating the next wave.
            if self.cache.write_index > self.prompt_len:
                self.cache.reset()
                self.num_rollovers += 1
                registry().counter("serve_rollovers").inc()
        while True:
            slot = next(
                (i for i, s in enumerate(self._slots) if s is None), None
            )
            if slot is None:
                break
            entry, shed = self.queue.pop(fit=self._fits)
            self._record_shed(shed, "shed_timeout")
            if entry is None:
                break
            self._seat(entry, slot)
        if (not self.paged and self._active()
                and self.cache.write_index < self.prompt_len):
            # Fresh cache just seated its first wave: the batch-1 row
            # caches carried their own write indices (discarded by
            # insert); pin the shared index past the prompt region.
            self.cache.set_write_index(self.prompt_len)
        registry().gauge("serve_slots_busy").set(
            sum(s is not None for s in self._slots)
        )

    def _fits(self, request) -> bool:
        """Can this request be seated RIGHT NOW? Dense: its worst case
        fits the remaining shared write horizon. Paged: its worst case
        fits the per-slot bound and enough pool pages are free to reserve
        it up front (so it never strands mid-decode). Radix mode counts
        only the UNSHARED pages (matched prefix pages seat for free), and
        left-aligned seating reserves from the real prompt length, not the
        padded window. A speculating engine also needs room in the draft
        cache. With adapters, the tenant's pages must be securable too
        (resident, or loadable by evicting lease-free adapters)."""
        if self.adapter_pool is not None and request.tenant is not None:
            if not self.adapter_pool.can_seat(request.tenant):
                return False
        if self.speculator is not None:
            # Pad-aligned draft seating reserves the full prompt window.
            draft_need = self.prompt_len + request.max_new_tokens
            if draft_need > self.speculator.cache.max_seq_len or not (
                    self.speculator.cache.fits_tokens(draft_need)):
                return False
        if self.prefix_share:
            need = len(request.input_ids) + request.max_new_tokens
            return need <= self.max_seq_len and self.cache.fits_request(
                request.input_ids, need)
        if self.paged:
            need = self.prompt_len + request.max_new_tokens
            return need <= self.max_seq_len and self.cache.fits_tokens(need)
        base = max(self.cache.write_index, self.prompt_len)
        return base + request.max_new_tokens <= self.max_seq_len

    # -- stepping ------------------------------------------------------

    def _maybe_finish(self, slot: int, token: int) -> None:
        s = self._slots[slot]
        req = s.request
        if req.eos_id is not None and token == req.eos_id:
            self._finish(slot, "eos")
        elif len(s.tokens) >= req.max_new_tokens:
            self._finish(slot, "length")

    def _finish(self, slot: int, reason: str) -> None:
        s = self._slots[slot]
        req = s.request
        n = len(s.tokens)
        tpot = (s.t_last - s.t_first) / (n - 1) if n > 1 else None
        ttft = s.t_first - s.entry.submitted_at
        queue_wait = s.t_seated - s.entry.submitted_at
        self.results[req.request_id] = Result(
            request_id=req.request_id,
            tokens=list(s.tokens),
            finish_reason=reason,
            ttft_s=ttft,
            tpot_s=tpot,
            # Queue wait ends at SEATING (pop), not first token — TTFT
            # additionally carries the prefill.
            queue_wait_s=queue_wait,
        )
        reg = registry()
        reg.counter("serve_requests_completed").inc()
        reg.counter("serve_tokens_generated").inc(n)
        if tpot is not None:
            reg.histogram("serve_tpot_ms").observe(1e3 * tpot)
        rec = active_recorder()
        if rec is not None:
            rec.event(
                "request_complete", CAT_SERVE_REQUEST,
                request_id=req.request_id, finish_reason=reason,
                ttft_s=ttft, tpot_s=tpot, queue_wait_s=queue_wait,
                generation_s=s.t_last - s.t_first, num_tokens=n,
                # The tenant and the reloads its seating paid, the prompt
                # tokens the radix cache served, the draft tokens proposed
                # and accepted (tpudl writes these into its request log,
                # not ported yet).
                **({"tenant": req.tenant, "adapter_reloads":
                    s.adapter_reloads} if self.adapter_pool is not None
                   else {}),
                **({"prefix_hit_tokens": s.prefix_hit} if self.prefix_share
                   else {}),
                **({"spec_proposed": s.spec_proposed,
                    "spec_accepted": s.spec_accepted}
                   if self.speculator is not None else {}),
            )
        self.cache.free(slot)
        if self.speculator is not None:
            self.speculator.free(slot)
        if self.adapter_pool is not None:
            # Drops the slot's tenant pin; the adapter stays cached at
            # refcount 0 (the evictable pool) for the next request.
            self.adapter_pool.free_slot(slot)
        self._slots[slot] = None

    def _decode_step(self) -> None:
        """One slot-batched decode call + selection + host readback; idle
        slots ride along with zeros and their output is discarded (paged:
        idle rows write into the trash page)."""
        assert self.paged or self.cache.write_index < self.max_seq_len, (
            "decode past the cache horizon (admission fit checks should "
            "make this unreachable)"
        )
        b = self.num_slots
        tokens = np.zeros(b, np.int32)
        positions = np.zeros(b, np.int32)
        temps = np.zeros(b, np.float32)
        seeds = np.zeros(b, np.uint32)
        steps = np.zeros(b, np.int32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            tokens[i] = s.tokens[-1]
            positions[i] = s.position
            temps[i] = s.request.temperature
            seeds[i] = s.request.seed
            steps[i] = s.steps
        rec = active_recorder()
        t0 = self.clock()
        args = (self.params, self.cache.cache, tokens, positions)
        if self.paged:
            args += self.cache.dispatch_args()
        if self.adapter_pool is not None:
            args += self.adapter_pool.dispatch_args()
        logits, self.cache.cache = self.decode_call(*args)
        greedy = getattr(self.decode_call, "greedy", None)
        # The per-step token readback is the one intended device-to-host
        # sync of the decode loop.
        if temps.any():
            sel = _select_tokens(logits, temps, seeds, steps, greedy)
        else:
            sel = _select_greedy(logits, greedy)
        if self.paged:
            # Each ACTIVE slot's logical length advanced by one (idle
            # slots stay on the trash page).
            self.cache.advance(
                [i for i, s in enumerate(self._slots) if s is not None])
        else:
            self.cache.advance_write_index()
        now = self.clock()
        if rec is not None:
            rec.record("decode_step", CAT_SERVE_DECODE, t0, now - t0,
                       {"busy": int(sum(s is not None for s in self._slots)),
                        "rids": [s.request.request_id
                                 for s in self._slots if s is not None]})
        self.num_decode_steps += 1
        registry().counter("serve_decode_steps").inc()
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            s.position += 1
            s.steps += 1
            s.t_last = now
            tok = int(sel[i])
            s.tokens.append(tok)
            if self.on_token is not None:
                self.on_token(s.request.request_id, tok)
            self._maybe_finish(i, tok)

    def _spec_step(self) -> None:
        """One speculative window: k draft calls propose, ONE slot-batched
        target chunk call verifies, acceptance emits 1..k tokens a slot.
        Rollback of a rejected tail is per-slot ``lens`` bookkeeping on
        both caches (tpudl_torch.serve.speculate's lockstep contract: both
        saw the same window, both advance by the emitted count)."""
        from tpudl_torch.serve.speculate import (
            greedy_accept,
            sample_accept,
            softmax,
        )

        spec = self.speculator
        k = spec.k
        b = self.num_slots
        active = [i for i, s in enumerate(self._slots) if s is not None]
        tokens0 = np.zeros(b, np.int32)
        positions0 = np.zeros(b, np.int32)
        temps = np.zeros(b, np.float32)
        seeds = np.zeros(b, np.uint32)
        token_index = np.zeros(b, np.int32)
        for i in active:
            s = self._slots[i]
            tokens0[i] = s.tokens[-1]
            positions0[i] = s.position
            temps[i] = s.request.temperature
            seeds[i] = s.request.seed
            token_index[i] = s.steps
        rids = [self._slots[i].request.request_id for i in active]
        rec = active_recorder()
        t0 = self.clock()
        proposals, q_probs = spec.propose(tokens0, positions0, active, temps,
                                          seeds, token_index)
        # Verify window [t_last, p_1 .. p_{k-1}]: k input rows write k KV
        # positions and give the target's verdict on p_1 .. p_k.
        chunk = np.concatenate([tokens0[:, None], proposals[:, :k - 1]],
                               axis=1)
        pos_chunk = positions0[:, None] + np.arange(k, dtype=np.int32)[None, :]
        lens_before = {i: int(self.cache.lens[i]) for i in active}
        logits, self.cache.cache = self.verify_call(
            self.params, self.cache.cache, chunk, pos_chunk,
            *self.cache.dispatch_args())
        sampling = any(temps[i] > 0 for i in active)
        if sampling:
            host_logits = logits.float().cpu().numpy()
            target_choice = host_logits.argmax(axis=-1).astype(np.int32)
        else:
            target_choice = _select_greedy(
                logits, getattr(self.verify_call, "greedy", None))
        now = self.clock()
        total_emitted = 0
        total_accepted = 0
        slot_accepted: List[int] = []  # aligned with rids (= active order)
        slot_emitted: List[int] = []
        for i in active:
            s = self._slots[i]
            req = s.request
            if temps[i] > 0:
                p_list = [softmax(host_logits[i, j], float(temps[i]))
                          for j in range(k)]
                emitted, accepted = sample_accept(
                    proposals[i], q_probs[i], p_list, int(seeds[i]),
                    int(token_index[i]))
            else:
                emitted, accepted = greedy_accept(proposals[i],
                                                  target_choice[i])
            emitted = emitted[: req.max_new_tokens - len(s.tokens)]
            if req.eos_id is not None:
                for idx, tok in enumerate(emitted):
                    if tok == req.eos_id:
                        emitted = emitted[: idx + 1]
                        break
            n = len(emitted)
            # Rollback + advance in one move: lens lands exactly past the
            # emitted rows; the rejected tail's page writes are masked
            # rows the next window overwrites.
            self.cache.set_len(i, lens_before[i] + n)
            spec.sync_len(i, n)
            s.position += n
            s.steps += n
            s.t_last = now
            s.spec_proposed += k
            s.spec_accepted += min(accepted, n)
            total_emitted += n
            total_accepted += min(accepted, n)
            slot_accepted.append(min(accepted, n))
            slot_emitted.append(n)
            for tok in emitted:
                s.tokens.append(int(tok))
                if self.on_token is not None:
                    self.on_token(req.request_id, int(tok))
                self._maybe_finish(i, int(tok))
                if self._slots[i] is None:
                    break
        if rec is not None:
            # accepted / proposed on every speculative decode step; the
            # per-slot lists align with rids, so one request's trace sums
            # its own numbers.
            rec.record("decode_step", CAT_SERVE_DECODE, t0, now - t0,
                       {"busy": len(active), "rids": rids,
                        "proposed": k * len(active),
                        "proposed_per_slot": k,
                        "accepted": total_accepted,
                        "emitted": total_emitted,
                        "slot_accepted": slot_accepted,
                        "slot_emitted": slot_emitted})
        self.num_decode_steps += 1
        reg = registry()
        reg.counter("serve_decode_steps").inc()
        reg.counter("spec_proposed_tokens").inc(k * len(active))
        reg.counter("spec_accepted_tokens").inc(total_accepted)
        reg.counter("spec_emitted_tokens").inc(total_emitted)
        # One slot-step per active slot per window: accepted / slot_steps
        # is the per-STREAM acceptance rate.
        reg.counter("spec_slot_steps").inc(len(active))

    def step(self) -> bool:
        """Seat what fits, run one decode step (a speculative window when
        a speculator is attached). False when fully drained (no active
        slots and nothing seatable queued)."""
        self._fill_slots()
        if not self._active():
            # Nothing seated: the queue is empty or held only expired
            # entries (shed during the fill's pop).
            self._record_shed(self.queue.drain_expired(), "shed_timeout")
            return False
        if self.speculator is not None:
            self._spec_step()
        else:
            self._decode_step()
        return True

    def run_until_drained(self) -> Dict[Any, Result]:
        while self.step():
            pass
        registry().gauge("serve_slots_busy").set(0)
        return self.results
