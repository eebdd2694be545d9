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

Two hooks for work that paid its prefill elsewhere, drained by
``_fill_slots`` ahead of the local queue: ``migrate_inbox`` (``_Migrated``
payloads of ``export_request``: a request's pages, tokens and sampling
position, resumed by ``install_migrated`` with no prefill) and
``prefill_inbox`` (``_Prefilled`` row caches of another engine's
prefill: prefill/decode disaggregation over the same seat). tpudl's
router feeds both (ROADMAP queue A item 16(c)); here any caller can.

Failure paths and live state: ``chaos_hooks`` (tpudl_torch.serve.chaos,
env-gated) run at the top of every ``step``; ``health()`` is the
``serve_engine`` source of /healthz (tpudl_torch.obs.exporter) through a
weak reference; ``attach_slo`` subscribes admission to a
tpudl_torch.obs.slo.SloMonitor, which sheds the queue while an objective
burns. Still to come: the request log and metering (ROADMAP queue A item
16(b)).
"""

from __future__ import annotations

import collections
import json
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpudl_torch.models.generate import gumbel_argmax
from tpudl_torch.obs import registry
from tpudl_torch.obs.spans import active_recorder
from tpudl_torch.rng import fold_in
from tpudl_torch.serve import chaos as serve_chaos
from tpudl_torch.serve.api import Request, Result
from tpudl_torch.serve.cache import (
    MigrationCompatError,
    MigrationCorruptError,
    SlotCache,
    parse_migration,
)
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


def _clone_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class _Prefilled:
    """One request another engine prefilled, awaiting a decode slot: the
    handoff unit of prefill/decode disaggregation (drained by
    ``Engine._fill_slots``). It holds its OWN copy of the row cache: a
    captured prefill's row cache is its graph's output buffer, which the
    next replay overwrites."""

    __slots__ = (
        "entry", "row_cache", "first_token", "prompt_ids_len",
        "t_popped", "t_first",
    )

    def __init__(self, entry: _Entry, row_cache: Any, first_token: int,
                 prompt_ids_len: int, t_popped: float, t_first: float):
        self.entry = entry
        self.row_cache = _clone_tree(row_cache)
        self.first_token = first_token
        self.prompt_ids_len = prompt_ids_len
        self.t_popped = t_popped  # queue wait ended here (prefill start)
        self.t_first = t_first  # first token selected here (TTFT end)


def prefill_handoff(engine: "Engine", request: Request,
                    submitted_at: Optional[float] = None) -> _Prefilled:
    """Prefill ``request`` on ``engine``'s batch-1 prefill (left-padded to
    its prompt window) and select its first token, as a dedicated prefill
    worker does (tpudl's router ``PrefillWorker``, ROADMAP queue A item
    16(c)): the ``_Prefilled`` another engine's ``prefill_inbox`` seats.
    Counts as a prefill of ``engine``. Tenants stay off this path, as
    tpudl's router keeps them (an adapter engine's prefill takes the
    tenant's pages)."""
    if engine.adapter_pool is not None:
        raise ValueError("prefill_handoff runs the plain batch-1 prefill; "
                         "an adapter-serving engine does not hand off")
    t0 = engine.clock()
    ids = np.asarray(request.input_ids, np.int32)
    row_cache, first = engine._full_prefill(ids, request)
    now = engine.clock()
    engine._count_prefill()
    registry().counter("serve_disaggregated_prefills").inc()
    entry = _Entry(priority=request.priority, seq=0, request=request,
                   deadline=None,
                   submitted_at=t0 if submitted_at is None else submitted_at)
    return _Prefilled(entry, row_cache, first, int(ids.shape[0]), t0, now)


class _Slot:
    """Host-side state of one occupied decode slot."""

    __slots__ = (
        "entry", "request", "tokens", "position", "steps",
        "t_seated", "t_first", "t_last", "gap_origin", "adapter_reloads",
        "prefix_hit", "spec_proposed", "spec_accepted", "migrations",
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
        # Migrated slots: the SOURCE's last-token time, consumed when the
        # first token after the move lands (the failover token gap).
        self.gap_origin: Optional[float] = None
        # Adapter reloads this request's seating paid for.
        self.adapter_reloads = 0
        # Prompt tokens the radix cache served; draft tokens proposed
        # and accepted (tpudl writes these into its request log).
        self.prefix_hit = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Moves survived (rides the payload, so it counts cumulatively).
        self.migrations = 0


def _received(payload):
    """A migration payload as this engine receives it: the transfer
    point, where ``TPUDL_SERVE_CHAOS_FLIP_MIGRATION`` flips a bit of the
    wire bytes (tpudl_torch.serve.chaos) for the crc to catch. A parsed
    payload (a dict) did not cross a wire."""
    if isinstance(payload, dict):
        return payload
    return serve_chaos.maybe_corrupt_migration(payload)


class _Migrated:
    """One migrated-in request awaiting a free slot: the payload as
    transferred (its crc checked lazily, on the engine's thread, so a
    corrupt transfer becomes a ``failed`` Result) and the radix lease the
    caller pinned on this cache for the prefix the export skipped."""

    __slots__ = ("rid", "payload", "lease", "meta")

    def __init__(self, rid: Any, payload, lease=None):
        self.rid = rid
        self.payload = _received(payload)
        self.lease = lease
        self.meta: Optional[dict] = None

    def ensure_parsed(self) -> dict:
        if self.meta is None:
            self.meta = (self.payload if isinstance(self.payload, dict)
                         else parse_migration(self.payload))
        return self.meta


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
        # Disaggregation inbox: _Prefilled items seated by _fill_slots
        # ahead of local queue pops (deque appends are thread-safe).
        self.prefill_inbox = collections.deque()
        # Migration inbox: _Migrated items, drained AHEAD of everything
        # else (this work already paid its prefill somewhere).
        self.migrate_inbox = collections.deque()
        # Chaos injection (tpudl_torch.serve.chaos, env-gated, default
        # none): hooks called with the decode-step count at the top of
        # step().
        self.chaos_hooks: List[Callable[[int], None]] = (
            serve_chaos.engine_step_hooks())
        # Decode steps are the deterministic cost unit the
        # static-vs-continuous comparison uses.
        self.num_decode_steps = 0
        self.num_prefills = 0
        self.num_rollovers = 0
        # SLO hook (attach_slo): while any subscribed objective burns,
        # admission sheds the queue instead of seating doomed work.
        self._slo = None
        self._slo_burning: frozenset = frozenset()
        registry().gauge("serve_cache_bytes").set(cache.nbytes)
        # Live health: slots and queue on /healthz while this engine is
        # the process's serving engine (the latest one wins). The source
        # holds a WEAK reference: a bound method would pin the engine and
        # its whole cache for the process lifetime.
        from tpudl_torch.obs import exporter as obs_exporter

        self_ref = weakref.ref(self)

        def _engine_health() -> dict:
            eng = self_ref()
            if eng is None:
                return {"healthy": True, "engine": "collected"}
            return eng.health()

        obs_exporter.register_health_source("serve_engine", _engine_health)

    # -- live telemetry ------------------------------------------------

    def health(self) -> dict:
        """/healthz payload: slot occupancy and admission state (both
        inboxes count as queued). Burning SLO objectives surface through
        the monitor's own source; here they only annotate."""
        out = {
            "healthy": True,
            "slots_busy": sum(s is not None for s in self._slots),
            "num_slots": self.num_slots,
            "queue_depth": (len(self.queue) + len(self.prefill_inbox)
                            + len(self.migrate_inbox)),
            "queue_capacity": self.queue.capacity,
            "results_pending": len(self.results),
            "decode_steps": self.num_decode_steps,
            "prefills": self.num_prefills,
            "max_seq_len": self.max_seq_len,
            "slo_burning": sorted(self._slo_burning),
            "paged": self.paged,
        }
        if self.paged:
            out["free_pages"] = self.cache.free_pages
            out["page_size"] = self.cache.page_size
            out["kv_quantized"] = self.cache.quantized
            if self.prefix_share:
                out["prefix_cache"] = self.cache.radix.stats()
            if self.speculator is not None:
                out["spec_k"] = self.speculator.k
            if self.adapter_pool is not None:
                out["adapters"] = self.adapter_pool.stats()
        else:
            out["write_index"] = self.cache.write_index
        return out

    def attach_slo(self, monitor) -> None:
        """Subscribe admission to a tpudl_torch.obs.slo.SloMonitor: the
        engine feeds it TTFT, queue-wait and TPOT observations, and while
        any objective burns, queued-but-unseated requests are shed
        (``finish_reason="shed_slo"``). The subscription holds a WEAK
        engine reference, so a monitor outliving the engine does not pin
        its cache."""
        self_ref = weakref.ref(self)

        def _on_transition(objective, state):
            eng = self_ref()
            if eng is None:
                return
            if state["burning"]:
                eng._slo_burning = eng._slo_burning | {objective.name}
            else:
                eng._slo_burning = eng._slo_burning - {objective.name}
            registry().gauge("slo_burning").set(len(eng._slo_burning))

        self._slo = monitor
        monitor.subscribe(_on_transition)
        monitor.evaluate()

    def _slo_observe(self, metric: str, value: float) -> None:
        if self._slo is not None:
            self._slo.observe(metric, value)

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
                row_offset = 0  # chunk rows are already left-aligned
                # A captured call's logits and argmax are its graph's
                # buffers: the token is read before the next call replays.
                first = first_token(
                    logits, req,
                    getattr(self.chunk_prefill_call, "greedy", None))
            else:
                hit = 0  # no chunk call: a full prefill, pages dedup only
                row_cache, first = self._full_prefill(
                    ids, req, (arow, ascale) if pool is not None else None)
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
        self._count_prefill()
        self._install(entry, slot, row_cache, first, ids.shape[0], t0, now,
                      pool.num_reloads - reloads0 if pool is not None else 0,
                      lease=lease, row_offset=row_offset, prefix_hit=hit,
                      tenant_pinned=pool is not None)

    def _full_prefill(self, ids: np.ndarray, req: Request,
                      adapter=None):
        """The batch-1 prefill of ``ids``, left-padded to the prompt
        window, and its first token: ``(row_cache, first)``. ``adapter``
        is the tenant's pinned ``(row, scale)`` on an adapter engine. A
        captured prefill's logits, argmax and row cache are its graph's
        buffers: the token is read here, and the caller copies the row
        (``_install``, ``_Prefilled``) before the next prefill replays."""
        pad = self.prompt_len - ids.shape[0]
        padded = np.concatenate([np.zeros(pad, np.int32), ids])[None, :]
        mask = np.concatenate(
            [np.zeros(pad, np.int32), np.ones(ids.shape[0], np.int32)]
        )[None, :]
        if adapter is not None:
            arow, ascale = adapter
            logits, row_cache = self.prefill_call(
                self.params, padded, mask, self.adapter_pool.pools,
                arow[None, :], np.float32([ascale]))
        else:
            logits, row_cache = self.prefill_call(self.params, padded, mask)
        return row_cache, first_token(
            logits, req, getattr(self.prefill_call, "greedy", None))

    def _count_prefill(self) -> None:
        self.num_prefills += 1
        registry().counter("serve_prefills").inc()

    def _seat_prefilled(self, item: _Prefilled, slot: int) -> None:
        """Seat a request another engine already prefilled (prefill/decode
        disaggregation): the same seat, no local prefill."""
        self._install(item.entry, slot, item.row_cache, item.first_token,
                      item.prompt_ids_len, item.t_popped, item.t_first)

    def _install(self, entry: _Entry, slot: int, row_cache: Any,
                 first: int, ids_len: int, t_popped: float,
                 t_first: float, adapter_reloads: int = 0, lease=None,
                 row_offset: Optional[int] = None, prefix_hit: int = 0,
                 tenant_pinned: bool = False) -> None:
        """Seat tail: cache insertion (dense copy, paged reservation and
        scatter, or radix-shared left-aligned seat), the draft cache's
        seat, adapter binding (the seat's pin moves to the slot), latency
        accounting, slot activation. ``row_offset`` None: a full
        prefill's left-padded row."""
        req = entry.request
        tenant = req.tenant
        if self.adapter_pool is not None and not tenant_pinned:
            # Externally prefilled path (no _seat ran): pin here, so that
            # a bound slot always holds a pin.
            self.adapter_pool.acquire(tenant)
        try:
            if self.prefix_share:
                if lease is None:
                    # A handed-off full-prefill row: matched pages still
                    # dedup (their values are identical).
                    lease = self.cache.match_and_lease(
                        np.asarray(req.input_ids, np.int32))
                self.cache.seat_shared(
                    row_cache, slot, req.input_ids,
                    ids_len + req.max_new_tokens, lease=lease,
                    row_offset=(self.prompt_len - ids_len
                                if row_offset is None else row_offset))
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
        self._slo_observe("serve_queue_wait_ms", queue_wait_ms)
        self._slo_observe("serve_ttft_ms", ttft_ms)
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

    def _free_slot(self) -> Optional[int]:
        return next((i for i, s in enumerate(self._slots) if s is None), None)

    def _fill_slots(self) -> None:
        """Seat work into empty slots: migrated-in requests first, then
        prefilled ones, then the queue. Static mode only refills once the
        WHOLE batch drained; continuous mode refills the moment a slot
        frees."""
        if self._slo is not None:
            # Drive burn transitions from the engine's own thread (the
            # subscriber flips _slo_burning synchronously), then shed:
            # queued work would only be served into a blown objective.
            self._slo.evaluate()
            if self._slo_burning and len(self.queue):
                self._record_shed(self.queue.drain_all(), "shed_slo")
        if not self.continuous and self._active():
            return
        if (not self.paged and not self._active()
                and (len(self.queue) or self.prefill_inbox)):
            # Batch drained with work queued: recover the full write
            # horizon before seating the next wave.
            if self.cache.write_index > self.prompt_len:
                self.cache.reset()
                self.num_rollovers += 1
                registry().counter("serve_rollovers").inc()
        # Migrated-in requests seat FIRST: their prefill and some decode
        # are paid, and every step of delay widens the client's stall.
        while self.migrate_inbox:
            slot = self._free_slot()
            if slot is None:
                break
            item = self.migrate_inbox[0]
            try:
                meta = item.ensure_parsed()
            except Exception as e:
                # Corrupt transfer: caught by the crc at the door, shed
                # as failed — never resumed.
                self.migrate_inbox.popleft()
                self._fail_migrated(item.rid, e, lease=item.lease)
                continue
            if not self._fits_migrated(meta):
                if self._fits_migrated(meta, empty=True):
                    break  # fits once seated work frees pages
                self.migrate_inbox.popleft()
                self._fail_migrated(
                    item.rid, RuntimeError(
                        "migrated reservation cannot fit this cache even "
                        "empty"), lease=item.lease, meta=meta)
                continue
            self.migrate_inbox.popleft()
            try:
                self.install_migrated(meta, slot=slot, lease=item.lease)
            except (MigrationCorruptError, MigrationCompatError,
                    ValueError, RuntimeError) as e:
                # install/import released the lease on their own failure
                # paths: report only.
                self._fail_migrated(item.rid, e, meta=meta)
        # Prefilled requests next: their prefill is paid, a queue pop
        # would pay one here.
        while self.prefill_inbox:
            slot = self._free_slot()
            if slot is None:
                break
            head = self.prefill_inbox[0].entry.request
            if not self._fits(head):
                if self._fits(head, empty=True):
                    break  # fits once seated work frees capacity
                # A never-fitting head would block every prefilled request
                # behind it forever (the inbox has no fit-filtered pop):
                # shed it.
                self._record_shed([self.prefill_inbox.popleft().entry],
                                  "shed_capacity")
                continue
            self._seat_prefilled(self.prefill_inbox.popleft(), slot)
        while True:
            slot = self._free_slot()
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

    def _fits(self, request, empty: bool = False) -> bool:
        """Can this request be seated RIGHT NOW (``empty``: in an EMPTY
        cache, where False means waiting can never help)? Radix mode
        reserves from the real prompt length (left-aligned seating; its
        matched prefix pages seat for free), the others from the padded
        window; pad-aligned draft seating reserves the full window."""
        spec = self.speculator is not None
        return self._can_reserve(
            (len(request.input_ids) if self.prefix_share else self.prompt_len)
            + request.max_new_tokens,
            self.prompt_len + request.max_new_tokens if spec else None,
            request.input_ids,
            request.tenant if self.adapter_pool is not None else None,
            self.prefix_share, empty)

    def _fits_migrated(self, meta: dict, empty: bool = False) -> bool:
        """``_fits`` for a migrated payload's reservation: rows written so
        far plus one a token still to generate, the draft's the same
        (lens-lockstep); the radix path credits the matched prefix of a
        left-aligned payload, and a tenant's adapter must be securable."""
        reserve = int(meta["reserve_tokens"])
        req = meta["request"]
        return self._can_reserve(
            reserve,
            reserve if self.speculator is not None and "draft" in meta
            else None,
            req["input_ids"], req.get("tenant"),
            self.prefix_share and bool(meta.get("left_aligned")), empty)

    def _can_reserve(self, need: int, draft_need: Optional[int], ids,
                     tenant: Any, shared: bool, empty: bool) -> bool:
        """The admission policy, in one place: can ``need`` target rows
        (and ``draft_need`` draft rows; None without a draft) be reserved
        up front, so a seated request never strands mid-decode, now or
        (``empty``) in an empty cache? Dense: the worst case fits the
        remaining shared write horizon. Paged: it fits the per-slot
        bound and enough pool pages are free (page 0 is the trash page;
        radix mode counts only the pages the tree does not hold for
        ``ids`` when ``shared``, and evicts cached pages on demand).
        ``tenant``: the adapter the seat pins (resident, or loadable by
        evicting lease-free adapters); an engine without an adapter pool
        cannot pin one."""
        if need > self.max_seq_len:
            return False
        if tenant is not None:
            pool = self.adapter_pool
            if pool is None or not (pool.can_ever_seat(tenant) if empty
                                    else pool.can_seat(tenant)):
                return False
        if draft_need is not None:
            dc = self.speculator.cache
            if draft_need > dc.max_seq_len or not (
                    dc.pages_needed(draft_need) <= dc.num_pages - 1 if empty
                    else dc.fits_tokens(draft_need)):
                return False
        if not self.paged:
            return empty or (max(self.cache.write_index, self.prompt_len)
                             - self.prompt_len + need <= self.max_seq_len)
        if empty:
            return self.cache.pages_needed(need) <= self.cache.num_pages - 1
        if shared:
            return self.cache.fits_request(ids, need)
        return self.cache.fits_tokens(need)

    # -- page-granular migration ---------------------------------------

    def export_request(self, rid: Any, skip_prefix_tokens: int = 0):
        """Ship one SEATED request's decode state — its KV pages (int8 as
        int8), generated tokens, sampling position (the ``fold_in`` token
        index) and absolute deadline — as a crc32-guarded payload that
        another engine's ``install_migrated`` resumes with no prefill. A
        speculating engine also ships the draft's rows, as a nested
        payload under the ``draft:payload`` leaf, so draft and target
        cross in lens-lockstep. Returns ``None`` when the request is not
        seated here, the cache is dense (dense rows are not
        position-independent), or an id does not survive JSON: the
        caller's cue to resubmit from scratch.

        ``skip_prefix_tokens`` leaves that many leading rows out (the
        caller probed and LEASED them in the target's radix tree).
        The slot is freed only once the payload exists in full."""
        if not self.paged:
            return None
        slot = next((i for i, s in enumerate(self._slots)
                     if s is not None and s.request.request_id == rid), None)
        if slot is None:
            return None
        s = self._slots[slot]
        req = s.request
        # The meta is JSON: an id (or tenant key) that does not round-trip
        # would resume under a MUTATED identity, or an unhashable one.
        for value in (req.request_id, req.session_key, req.tenant):
            try:
                if json.loads(json.dumps(value)) != value:
                    return None
            except (TypeError, ValueError):
                return None
        skip = int(skip_prefix_tokens)
        if skip and int(self.cache.start[slot]) != 0:
            skip = 0  # pad-aligned rows cannot ship by tree reference
        t0 = self.clock()
        meta = {
            "request": {
                "request_id": req.request_id,
                "input_ids": [int(t) for t in req.input_ids],
                "max_new_tokens": req.max_new_tokens,
                "eos_id": req.eos_id,
                "temperature": req.temperature,
                "seed": req.seed,
                "priority": req.priority,
                "deadline_s": req.deadline_s,
                "session_key": req.session_key,
                # Failover re-pins the tenant's adapter on the target.
                "tenant": req.tenant,
            },
            "tokens": [int(t) for t in s.tokens],
            "position": s.position,
            "steps": s.steps,
            "prompt_ids_len": len(req.input_ids),
            "submitted_at": s.entry.submitted_at,
            "deadline_at": s.entry.deadline,
            "t_seated": s.t_seated,
            "t_first": s.t_first,
            "t_last": s.t_last,
            # Moves survived so far: the target counts cumulatively.
            "migrations": s.migrations,
            # What the target must reserve: rows written so far plus one
            # row per token still to generate.
            "reserve_tokens": int(self.cache.lens[slot])
            + max(0, req.max_new_tokens - len(s.tokens)),
        }
        extra_leaves = []
        if self.speculator is not None:
            # Draft lens equals target lens between windows, so the
            # reserve formula is the target's.
            draft_reserve = int(self.speculator.cache.lens[slot]) + max(
                0, req.max_new_tokens - len(s.tokens))
            draft_bytes = self.speculator.export_slot(
                slot, req.input_ids, draft_reserve)
            meta["draft"] = {"k": self.speculator.k,
                             "nbytes": len(draft_bytes)}
            extra_leaves.append(
                ("draft:payload", np.frombuffer(draft_bytes, np.uint8)))
        payload = self.cache.export_request(
            slot, meta, skip_tokens=skip, extra_leaves=extra_leaves)
        # Commit point: the payload exists in full — the local copy of
        # this request ends here (no double decode, no late Result).
        self.cache.free(slot)
        if self.speculator is not None:
            self.speculator.free(slot)
        if self.adapter_pool is not None:
            self.adapter_pool.free_slot(slot)
        self._slots[slot] = None
        reg = registry()
        reg.counter("serve_migrations_exported").inc()
        reg.counter("serve_migration_payload_bytes").inc(len(payload))
        rec = active_recorder()
        if rec is not None:
            rec.event("migration_export", CAT_SERVE_REQUEST,
                      request_id=rid, payload_bytes=len(payload),
                      skip_tokens=skip, tokens_done=len(s.tokens),
                      export_s=self.clock() - t0)
        return payload

    def install_migrated(self, payload, slot: Optional[int] = None,
                         lease=None) -> Any:
        """Seat an ``export_request`` payload into a free slot and resume
        decode where it stopped: the rows scatter into fresh pages, the
        sampling stream continues at the recorded token index, and no
        prefill runs here. The payload's absolute deadline holds: a
        transfer that used up the client's budget is recorded as
        ``shed_timeout``, never resumed. A tenant's adapter is pinned
        before any row lands. Raises ``MigrationCorruptError`` on a
        payload that fails the crc and ``MigrationCompatError`` on one
        this engine cannot seat. Returns the request_id."""
        try:
            if not self.paged:
                raise ValueError(
                    "migration requires a paged cache (dense rows are not "
                    "position-independent)")
            meta = (payload if isinstance(payload, dict)
                    and "_arrays" in payload
                    else parse_migration(_received(payload)))
            if self.speculator is not None and "draft" not in meta:
                # The draft cache would start empty while the target is
                # mid-stream: lens-lockstep broken.
                raise MigrationCompatError(
                    "this engine speculates but the payload carries no "
                    "draft remainder")
            req = Request(**meta["request"])
            entry = _Entry(priority=req.priority, seq=0, request=req,
                           deadline=meta.get("deadline_at"),
                           submitted_at=meta["submitted_at"])
        except BaseException:
            if self.paged:
                self.cache.release_lease(lease[1] if lease else None)
            raise
        if entry.deadline is not None and self.clock() > entry.deadline:
            # The transfer ate the remaining budget: shed at the door.
            self.cache.release_lease(lease[1] if lease else None)
            self._record_shed([entry], "shed_timeout")
            return req.request_id
        if slot is None:
            slot = self._free_slot()
        if slot is None:
            self.cache.release_lease(lease[1] if lease else None)
            raise RuntimeError("no free slot for the migrated request "
                               "(callers check for one before installing)")
        tenant_pinned = False
        if req.tenant is not None:
            if self.adapter_pool is None or not (
                    self.adapter_pool.knows(req.tenant)):
                self.cache.release_lease(lease[1] if lease else None)
                raise MigrationCompatError(
                    f"migrated request is tenant {req.tenant!r} but this "
                    f"engine's adapter pool does not serve it")
            # Resuming a tenant's decode on the bare base would silently
            # change its tokens.
            self.adapter_pool.acquire(req.tenant)
            tenant_pinned = True
        try:
            # Consumes the lease: released on every import failure path.
            self.cache.import_request(meta, slot, lease=lease)
            if self.adapter_pool is not None:
                self.adapter_pool.bind_slot(slot, req.tenant)
            if self.speculator is not None:
                try:
                    self.speculator.import_slot(
                        slot,
                        meta["_arrays"]["draft:payload"].numpy().tobytes())
                except BaseException:
                    # Target rows already landed: unwind them (both caches
                    # seat, or neither).
                    self.cache.free(slot)
                    if self.adapter_pool is not None:
                        self.adapter_pool.free_slot(slot)
                    raise
        except BaseException:
            if tenant_pinned:
                self.adapter_pool.release(req.tenant)
            raise
        s = _Slot(entry, int(meta["tokens"][0]), int(meta["prompt_ids_len"]),
                  float(meta["t_seated"]), float(meta["t_first"]))
        s.tokens = [int(t) for t in meta["tokens"]]
        s.position = int(meta["position"])
        s.steps = int(meta["steps"])
        s.t_last = float(meta["t_last"])
        s.gap_origin = float(meta["t_last"])
        # This install is one more move than the payload survived.
        s.migrations = int(meta.get("migrations", 0)) + 1
        self._slots[slot] = s
        registry().counter("serve_migrations_installed").inc()
        registry().gauge("serve_slots_busy").set(
            sum(x is not None for x in self._slots))
        rec = active_recorder()
        if rec is not None:
            rec.event("migration_install", CAT_SERVE_REQUEST,
                      request_id=req.request_id, slot=slot,
                      resumed_at_token=len(s.tokens))
        return req.request_id

    def _fail_migrated(self, rid: Any, exc: BaseException, lease=None,
                       meta: Optional[dict] = None) -> None:
        """A migrated payload that cannot be resumed (corrupt transfer,
        incompatible cache, unseatable reservation) becomes a ``failed``
        Result: the generation state is gone and resuming garbage is not
        allowed. ``meta`` is the parsed payload when the transfer passed
        the crc. tpudl also writes the terminal request-log record here,
        billing the payload's tenant (ROADMAP queue A item 16(b))."""
        if lease is not None and self.paged:
            self.cache.release_lease(lease[1])
        self.results[rid] = Result(
            request_id=rid, tokens=[],
            finish_reason=f"failed: {type(exc).__name__}: {exc}")
        reg = registry()
        reg.counter("serve_requests_failed").inc()
        reg.counter("serve_migrations_failed").inc()
        rec = active_recorder()
        if rec is not None:
            mreq = (meta or {}).get("request") or {}
            rec.event("request_complete", CAT_SERVE_REQUEST, request_id=rid,
                      finish_reason="failed",
                      error=f"{type(exc).__name__}: {exc}", num_tokens=0,
                      shed_by="migration", tenant=mreq.get("tenant"))

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
            self._slo_observe("serve_tpot_ms", 1e3 * tpot)
        rec = active_recorder()
        if rec is not None:
            rec.event(
                "request_complete", CAT_SERVE_REQUEST,
                request_id=req.request_id, finish_reason=reason,
                ttft_s=ttft, tpot_s=tpot, queue_wait_s=queue_wait,
                generation_s=s.t_last - s.t_first, num_tokens=n,
                # The tenant and the reloads its seating paid, the prompt
                # tokens the radix cache served, the draft tokens proposed
                # and accepted, the moves survived (tpudl writes these into
                # its request log: ROADMAP queue A item 16(b)).
                **({"tenant": req.tenant, "adapter_reloads":
                    s.adapter_reloads} if self.adapter_pool is not None
                   else {}),
                **({"prefix_hit_tokens": s.prefix_hit} if self.prefix_share
                   else {}),
                **({"spec_proposed": s.spec_proposed,
                    "spec_accepted": s.spec_accepted}
                   if self.speculator is not None else {}),
                **({"migrations": s.migrations} if s.migrations else {}),
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
            self._observe_gap(s, now)
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
            self._observe_gap(s, now)
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

    @staticmethod
    def _observe_gap(s: _Slot, now: float) -> None:
        if s.gap_origin is not None:
            # The first token after a migration: the client's stream
            # stalled from the SOURCE's last token until now (the
            # failover token gap; tpudl observes it on the plain decode
            # step, the port on the speculative window too).
            registry().histogram("serve_failover_token_gap_ms").observe(
                1e3 * (now - s.gap_origin))
            s.gap_origin = None

    def step(self) -> bool:
        """Seat what fits, run one decode step (a speculative window when
        a speculator is attached). False when fully drained (no active
        slots and nothing seatable queued)."""
        for hook in self.chaos_hooks:
            # Fault injection (tpudl_torch.serve.chaos): a kill hook
            # raises, a freeze hook sleeps here holding the whole loop.
            hook(self.num_decode_steps)
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
