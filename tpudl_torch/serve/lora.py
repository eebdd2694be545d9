"""Multi-tenant LoRA serving: the paged adapter pool.

The port's counterpart of tpudl.serve.lora. One base model stays
resident once; every tenant is a LoRA fine-tune whose A/B factors page
in and out of fixed-size pools as KV pages do. A **page is one rank
unit** — one column of every site's A factor and the matching row of
its B factor — so a rank-``r`` adapter owns ``r`` pages across all the
per-layer site pools at once, and the host-owned page table rides into
each call (tpudl_torch.models.generate.lora_paged_decode_fn) as a small
tensor. Physical page 0 is the never-written all-zero page: empty slots
and ranks short of ``r_max`` map to it and add exactly nothing through
the segmented kernel (tpudl_torch.ops.segmented_lora).

Lifecycle:

- ``register`` keeps a HOST copy of each tenant's factors (the reload
  source: eviction frees device pages only, so an evicted tenant's next
  request reloads transparently — ``serve_adapter_reloads_total``
  counts those);
- seating a request ``acquire``s its tenant (loading on demand,
  refcount + 1), so an adapter in use is never evicted mid-decode;
- under page pressure, refcount-0 residents evict LRU-first;
- ``dtype="int8"`` pools store one f32 dequant scale per page per site
  (the symmetric int8 rule at page granularity), applied inside the
  kernel's gather.

Thread model: the engine thread is the only mutator; all shared state
sits under one lock, so a reader on another thread (a router's
``resident_since`` probe) sees a consistent pool.

``assert_tenant_parity`` is the acceptance gate: the heterogeneous
batched engine against the sequential one-adapter-at-a-time reference
(each tenant's adapter MERGED into the base and run through
``generate()``) — exact tokens for f32 pages, the teacher-forced logit
margin for int8 pages.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpudl_torch.obs import registry
from tpudl_torch.ops.segmented_lora import SitePools

#: Symmetric int8 range and the scale floor (tpudl's values).
INT8_MAX = 127.0
SCALE_EPS = 1e-12


def _site_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """(in, out) per adaptable projection site of one Llama block."""
    h, hd = cfg.hidden_size, cfg.head_dim
    return {
        "q_proj": (h, cfg.num_heads * hd),
        "k_proj": (h, cfg.num_kv_heads * hd),
        "v_proj": (h, cfg.num_kv_heads * hd),
        "o_proj": (cfg.num_heads * hd, h),
        "gate_proj": (h, cfg.intermediate_size),
        "up_proj": (h, cfg.intermediate_size),
        "down_proj": (cfg.intermediate_size, h),
    }


def _site_key(path: str) -> Optional[Tuple[str, str]]:
    """'model.layer_3.attention.q_proj' (or tpudl's '/'-joined form) ->
    ('layer_3', 'q_proj')."""
    parts = path.replace("/", ".").split(".")
    layer = next((p for p in parts if p.startswith("layer_")), None)
    if layer is None:
        return None
    return layer, parts[-1]


def _quantize_rows(rows: np.ndarray):
    """Symmetric int8 per page row: ``rows`` [r, dim] -> (int8 rows, f32
    scale [r]); ``q * scale`` reconstructs to half a step of the row max
    (tpudl's rule, bit for bit)."""
    scale = np.maximum(np.abs(rows).max(axis=-1) / INT8_MAX,
                       SCALE_EPS).astype(np.float32)
    q = np.clip(np.round(rows / scale[:, None]), -INT8_MAX,
                INT8_MAX).astype(np.int8)
    return q, scale


class _Resident:
    """One tenant's device residency: its pages and the lease state."""

    __slots__ = ("pages", "rank", "scaling", "refcount", "stamp", "since")

    def __init__(self, pages: List[int], rank: int, scaling: float,
                 stamp: int, since: float):
        self.pages = pages
        self.rank = rank
        self.scaling = scaling
        self.refcount = 0
        self.stamp = stamp  # LRU recency (pool clock at last touch)
        self.since = since  # wall residency start


class AdapterPool:
    """Paged pool of per-tenant LoRA factors for one serving engine.

    ``cfg`` is the base model's LlamaConfig (site shapes derive from it);
    ``r_max`` is the per-tenant rank budget, the table's width;
    ``num_pages`` sizes the pool (page 0 is the all-zero page, never
    allocated; default 64 full-rank adapters + 1); ``dtype="int8"`` stores
    pages quantized with per-page f32 scales. The pools are made zeroed on
    ``device``. The pool owns the per-SLOT addressing the engine ships
    into each call (``slot_table``, ``slot_scale``), so the engine's
    surface is ``acquire`` / ``bind_slot`` / ``free_slot`` /
    ``dispatch_args``."""

    def __init__(self, cfg, r_max: int, num_slots: int,
                 num_pages: Optional[int] = None, dtype: Optional[str] = None,
                 clock=time.monotonic, device="cuda"):
        if r_max < 1:
            raise ValueError(f"r_max must be >= 1, got {r_max}")
        if dtype not in (None, "int8"):
            raise ValueError(f"adapter dtype must be None (f32 pages) or "
                             f"'int8', got {dtype!r}")
        if num_pages is None:
            num_pages = 64 * r_max + 1
        if num_pages < r_max + 1:
            raise ValueError(f"num_pages={num_pages} cannot hold one "
                             f"rank-{r_max} adapter (+ the zero page)")
        self.r_max = int(r_max)
        self.num_pages = int(num_pages)
        self.num_slots = int(num_slots)
        self.quantized = dtype == "int8"
        self.clock = clock
        self._sites = _site_shapes(cfg)
        self._layers = [f"layer_{i}" for i in range(cfg.num_layers)]
        store = torch.int8 if self.quantized else torch.float32
        #: The ``{layer: {site: {"a", "b"[, "a_scale", "b_scale"]}}}``
        #: every call carries; loads write into it in place. Each site's
        #: pools are held to the kernel's contract here, once
        #: (tpudl_torch.ops.segmented_lora.SitePools).
        self.pools: Dict[str, dict] = {}
        for layer in self._layers:
            self.pools[layer] = {}
            for site, (fin, fout) in self._sites.items():
                entry = {"a": torch.zeros(self.num_pages, fin, dtype=store,
                                          device=device),
                         "b": torch.zeros(self.num_pages, fout, dtype=store,
                                          device=device)}
                if self.quantized:
                    entry["a_scale"] = torch.zeros(self.num_pages,
                                                   device=device)
                    entry["b_scale"] = torch.zeros(self.num_pages,
                                                   device=device)
                self.pools[layer][site] = SitePools(entry)
        self._lock = threading.RLock()
        self._free: List[int] = list(range(1, self.num_pages))
        self._resident: Dict[Any, _Resident] = {}
        self._host: Dict[Any, dict] = {}
        self._was_resident: set = set()
        self._slot_tenant: Dict[int, Any] = {}
        self._clock_ticks = 0
        self.slot_table = np.zeros((self.num_slots, self.r_max), np.int32)
        self.slot_scale = np.zeros((self.num_slots,), np.float32)
        self.num_loads = 0
        self.num_reloads = 0
        self.num_evictions = 0

    # -- registration ---------------------------------------------------

    def register(self, tenant: Any, adapter: Any, alpha: float = 16.0) -> None:
        """Register one tenant's adapter (a LoRA state_dict, or the flat
        form of tpudl_torch.models.lora.as_flat_adapters; tpudl's flat
        form is taken too). Host-side only — device pages load lazily at
        the first acquire. Shapes and rank are validated here."""
        from tpudl_torch.models.lora import as_f32, as_flat_adapters

        flat = as_flat_adapters(adapter)
        if not flat:
            raise ValueError(f"tenant {tenant!r}: adapter holds no lora_a/"
                             f"lora_b leaves")
        sites: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}
        rank = None
        for path, factors in flat.items():
            key = _site_key(path)
            if key is None:
                raise ValueError(f"tenant {tenant!r}: adapter site {path!r} "
                                 f"names no layer_<i> segment")
            layer, site = key
            if site not in self._sites or layer not in self._layers:
                raise ValueError(
                    f"tenant {tenant!r}: {path!r} is not an adaptable site "
                    f"(known: {sorted(self._sites)} of {len(self._layers)} "
                    f"layers)")
            # The host copy: eviction frees device pages only.
            a, b = (as_f32(factors[k], "cpu").numpy()
                    for k in ("lora_a", "lora_b"))
            fin, fout = self._sites[site]
            if a.shape[0] != fin or b.shape[1] != fout or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"tenant {tenant!r}: {path!r} factors {a.shape}x"
                    f"{b.shape} do not fit site ({fin}, {fout})")
            if rank is None:
                rank = int(a.shape[1])
            elif int(a.shape[1]) != rank:
                raise ValueError(
                    f"tenant {tenant!r}: mixed ranks across sites ({rank} vs "
                    f"{a.shape[1]}) — one rank per tenant")
            sites[(layer, site)] = (a, b)
        if rank < 1 or rank > self.r_max:
            raise ValueError(f"tenant {tenant!r}: rank {rank} outside [1, "
                             f"r_max={self.r_max}]")
        with self._lock:
            res = self._resident.get(tenant)
            if res is not None:
                # The old factors must not keep serving from resident
                # pages: drop the residency so the next acquire loads the
                # new version. A leased residency is a caller error.
                if res.refcount > 0:
                    raise ValueError(
                        f"tenant {tenant!r} is leased by a seated request — "
                        f"re-register only between requests")
                self._resident.pop(tenant)
                self._free.extend(res.pages)
            self._host[tenant] = {"sites": sites, "rank": rank,
                                  "scaling": float(alpha) / rank}

    def knows(self, tenant: Any) -> bool:
        with self._lock:
            return tenant in self._host

    @property
    def tenants(self) -> List[Any]:
        with self._lock:
            return list(self._host)

    # -- residency ------------------------------------------------------

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Pages held by refcount-0 residents — reclaimable without
        touching any seated request."""
        with self._lock:
            return sum(r.rank for r in self._resident.values()
                       if r.refcount == 0)

    def can_seat(self, tenant: Any) -> bool:
        """Admission predicate: is (or could) this tenant's adapter be
        resident right now? The engine's ``_fits`` consults it so a
        request is seated only once its adapter pages are securable."""
        with self._lock:
            host = self._host.get(tenant)
            if host is None:
                return False
            if tenant in self._resident:
                return True
            return host["rank"] <= len(self._free) + self.evictable_pages

    def can_ever_seat(self, tenant: Any) -> bool:
        with self._lock:
            host = self._host.get(tenant)
            return host is not None and host["rank"] <= self.num_pages - 1

    def resident_since(self, tenant: Any) -> Optional[float]:
        """When this tenant's adapter became resident (None = not
        resident); lock-guarded, so another thread may call it."""
        with self._lock:
            res = self._resident.get(tenant)
            return res.since if res is not None else None

    def _ensure_resident(self, tenant: Any) -> _Resident:
        """Callers hold the lock. Loads the adapter (evicting LRU
        refcount-0 residents under pressure) when it is not resident."""
        res = self._resident.get(tenant)
        self._clock_ticks += 1
        if res is not None:
            res.stamp = self._clock_ticks
            return res
        host = self._host.get(tenant)
        if host is None:
            raise KeyError(f"tenant {tenant!r} is not registered with this "
                           f"pool")
        rank = host["rank"]
        while rank > len(self._free):
            victim = min(((tid, r) for tid, r in self._resident.items()
                          if r.refcount == 0),
                         key=lambda item: item[1].stamp, default=None)
            if victim is None:
                raise RuntimeError(
                    f"adapter pool exhausted: tenant {tenant!r} needs {rank} "
                    f"pages, {len(self._free)} free and every resident "
                    f"adapter is leased (admission should have checked "
                    f"can_seat)")
            tid, r = victim
            self._resident.pop(tid)
            self._free.extend(r.pages)
            self.num_evictions += 1
            registry().counter("serve_adapter_evictions_total").inc()
        pages = [self._free.pop() for _ in range(rank)]
        self._scatter(host, pages)
        res = _Resident(pages, rank, host["scaling"], self._clock_ticks,
                        self.clock())
        self._resident[tenant] = res
        self.num_loads += 1
        reg = registry()
        reg.counter("serve_adapter_loads_total").inc()
        if tenant in self._was_resident:
            self.num_reloads += 1
            reg.counter("serve_adapter_reloads_total").inc()
        self._was_resident.add(tenant)
        reg.gauge("serve_adapters_resident").set(len(self._resident))
        return res

    def _scatter(self, host: dict, pages: List[int]) -> None:
        """Write one tenant's rank rows into every (layer, site) pool at
        ``pages``, in place: page j holds A[:, j] and B[j, :]. Missing
        sites write zeros (pages are recycled: an evicted tenant's rows
        must not leak through)."""
        rank = len(pages)
        for layer in self._layers:
            for site, (fin, fout) in self._sites.items():
                factors = host["sites"].get((layer, site))
                if factors is None:
                    a_rows = np.zeros((rank, fin), np.float32)
                    b_rows = np.zeros((rank, fout), np.float32)
                else:
                    a_rows = np.ascontiguousarray(factors[0].T)  # [r, in]
                    b_rows = np.ascontiguousarray(factors[1])  # [r, out]
                entry = self.pools[layer][site]
                ids = torch.as_tensor(pages, device=entry["a"].device)
                for key, rows in (("a", a_rows), ("b", b_rows)):
                    if self.quantized:
                        rows, sc = _quantize_rows(rows)
                        entry[f"{key}_scale"][ids] = torch.tensor(
                            sc, device=ids.device)
                    entry[key][ids] = torch.tensor(rows, device=ids.device)

    # -- the engine surface ---------------------------------------------

    def acquire(self, tenant: Optional[Any]):
        """Pin one tenant for a request being seated (loading on demand):
        refcount + 1, so eviction never takes its pages mid-decode.
        Returns ``(table_row [r_max] int32, scaling)``, the batch-1
        prefill's addressing; ``tenant=None`` (the plain base) returns the
        zero row, unpinned."""
        row = np.zeros((self.r_max,), np.int32)
        if tenant is None:
            return row, 0.0
        with self._lock:
            res = self._ensure_resident(tenant)
            res.refcount += 1
            row[: res.rank] = res.pages
            return row, res.scaling

    def release(self, tenant: Optional[Any]) -> None:
        """Drop one ``acquire`` pin (failure paths; ``free_slot`` is the
        normal route). Refcount-0 residents stay cached — the evictable
        pool, reclaimed only under pressure."""
        if tenant is None:
            return
        with self._lock:
            res = self._resident.get(tenant)
            assert res is not None and res.refcount > 0, (
                f"release of unpinned tenant {tenant!r}")
            res.refcount -= 1

    def bind_slot(self, slot: int, tenant: Optional[Any]) -> None:
        """Point ``slot``'s table row at an ALREADY-ACQUIRED tenant's pages
        (the pin moves from the seat path to the slot; ``free_slot``
        drops it). ``tenant=None`` zeroes the row."""
        with self._lock:
            self.slot_table[slot, :] = 0
            self.slot_scale[slot] = 0.0
            if tenant is None:
                self._slot_tenant.pop(slot, None)
                return
            res = self._resident.get(tenant)
            assert res is not None, (
                f"bind_slot for non-resident tenant {tenant!r} — acquire "
                f"first")
            self.slot_table[slot, : res.rank] = res.pages
            self.slot_scale[slot] = res.scaling
            self._slot_tenant[slot] = tenant

    def free_slot(self, slot: int) -> None:
        """Zero the slot's addressing and drop its tenant pin."""
        with self._lock:
            tenant = self._slot_tenant.pop(slot, None)
            self.slot_table[slot, :] = 0
            self.slot_scale[slot] = 0.0
            if tenant is not None:
                res = self._resident.get(tenant)
                if res is not None and res.refcount > 0:
                    res.refcount -= 1

    def dispatch_args(self):
        """The three extra inputs every multi-tenant call carries: (pools,
        slot table [B, r_max] int32, slot scale [B] f32), the host arrays
        as copies."""
        with self._lock:
            return self.pools, self.slot_table.copy(), self.slot_scale.copy()

    # -- accounting -----------------------------------------------------

    def _pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for sites in self.pools.values()
                   for entry in sites.values() for t in entry.values())

    @property
    def nbytes(self) -> int:
        """Resident bytes: every pool tensor (int8 values and their f32
        scale rows) plus the host-side slot addressing."""
        with self._lock:
            return (self._pool_bytes() + self.slot_table.nbytes
                    + self.slot_scale.nbytes)

    @property
    def bytes_per_page(self) -> int:
        """Stored bytes one page (one rank unit) takes across every
        (layer, site) pool: a rank-r adapter costs ``r * bytes_per_page``."""
        return self._pool_bytes() // self.num_pages

    def adapters_per_gb(self, rank: Optional[int] = None) -> float:
        """Resident adapters one GB of pool holds at ``rank`` (default
        r_max)."""
        rank = self.r_max if rank is None else rank
        return 1e9 / (self.bytes_per_page * rank)

    def stats(self) -> dict:
        with self._lock:
            return {
                "registered": len(self._host),
                "resident": len(self._resident),
                "leased": sum(1 for r in self._resident.values()
                              if r.refcount > 0),
                "free_pages": len(self._free),
                "num_pages": self.num_pages,
                "r_max": self.r_max,
                "quantized": self.quantized,
                "loads": self.num_loads,
                "reloads": self.num_reloads,
                "evictions": self.num_evictions,
            }


def assert_tenant_parity(session, base_model, base_params,
                         adapters: Dict[Any, Any], requests: Sequence,
                         atol: Optional[float] = None,
                         alpha: float = 16.0) -> None:
    """Serve the whole multi-tenant batch through ONE heterogeneous engine
    run, then hold every greedy request against the sequential
    one-adapter-at-a-time reference: its tenant's adapter MERGED into the
    base state_dict (tpudl_torch.models.lora.merge_adapter) and decoded
    with plain ``generate()``. ``atol=None`` demands exact tokens (the f32
    page contract); ``atol`` set is the int8 page contract: a flip must be
    a near-tie under the teacher-forced logit margin
    (``assert_serving_parity``'s rule, per-tenant reference)."""
    from tpudl_torch.models.lora import as_flat_adapters, merge_adapter
    from tpudl_torch.serve.api import assert_tokens_match_generate

    results = session.serve(list(requests))
    merged: Dict[Any, Any] = {}
    for req in requests:
        if req.temperature != 0.0:
            continue
        res = results[req.request_id]
        assert res.ok, (req.request_id, res.finish_reason)
        tenant = req.tenant
        if tenant not in merged:
            merged[tenant] = base_params if tenant is None else merge_adapter(
                base_params, as_flat_adapters(adapters[tenant]), alpha=alpha)
        assert_tokens_match_generate(base_model, merged[tenant], req,
                                     np.asarray(res.tokens), atol)
