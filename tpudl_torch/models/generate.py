"""Autoregressive decoding with a KV cache (the Llama serving path).

The port's counterpart of tpudl.models.generate: the functional prefill
and single-token decode contracts the serving engine runs, and the
batched ``generate()`` loop. The contracts are plain functions (tpudl
jits them); ``params`` is the state_dict, bound into the model once
(tpudl_torch.models.llama.bind_params). Each contract, prefill and
decode, also carries its host checks, its device body, the arguments it
reads in place and its functional form (``fn.check``, ``fn.body``,
``fn.static_args``, ``fn.cache_arg``, ``fn.functional``): what
tpudl_torch.graphs.CapturedCall needs to capture it (the serving
engine's prefill and decode calls on the card are graphs) and what
tpudl_torch.export traces. ``generate()`` decodes in chunks, each a
CUDA graph on the card.

Greedy (temperature=0), temperature, top-k, and top-p (nucleus)
sampling. Ragged prompt batches are served LEFT-padded: the cache marks
padded slots invalid and masks by slot write-order, while mask-aware
positions keep RoPE phases identical to the unpadded prompt — so a
left-padded row generates token-for-token what it would alone.

Random draws come from an explicit ``torch.Generator``. They are not
JAX's bits: a sampled token stream matches itself across runs of the
port, not tpudl's.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpudl_torch.models.llama import bind_params, params_device


def _contract(model, run, static_args, check=None, cache_arg=None):
    """A contract ``fn(params, *args)``: ``check`` (host checks), then
    ``params`` bound into ``model`` (bind_params) and ``run(model, dev,
    *args)`` under ``torch.no_grad``, where ``run`` calls the model
    through its first argument and ``dev`` is the params' device.

    Kept on the function for tpudl_torch.graphs.CapturedCall and
    tpudl_torch.export: ``fn.check``; ``fn.body`` (the device work with
    no host checks and no host reads, on device or host arguments);
    ``fn.static_args`` (the arguments a captured call reads in place:
    the weights, the cache, the adapter pools; the rest it copies into
    static buffers); ``fn.cache_arg`` (the argument holding the cache
    the call writes in place and returns, None for a prefill, which
    returns a fresh one); ``fn.functional`` (the same device work with
    the model called through ``torch.func.functional_call`` on
    ``params``, which is what ``torch.export`` traces, under
    ``torch.no_grad``, on a module built on ``meta``: the artifact holds
    no weights and bind_params does not run in the trace); ``fn.model``."""

    check = check or (lambda *args: None)

    def body(params, *args):
        bind_params(model, params)
        with torch.no_grad():
            return run(model, params_device(params), *args)

    def functional(params, *args):
        def call(*a, **kw):
            return torch.func.functional_call(model, params, a, kw)

        return run(call, params_device(params), *args)

    def fn(*args):
        check(*args)
        return body(*args)

    fn.body = body
    fn.check = check
    fn.functional = functional
    fn.static_args = static_args
    fn.cache_arg = cache_arg
    fn.model = model
    return fn


def _prompt(dev, input_ids, attention_mask):
    ids = torch.as_tensor(input_ids, device=dev)
    mask = torch.as_tensor(attention_mask, device=dev)
    return ids, mask, (mask.cumsum(-1) - 1).clamp_min(0)


def _check_prompt(input_ids, attention_mask) -> None:
    """The prefill contracts' host checks: a [B, S] prompt and its mask,
    LEFT-padded (``validate_left_padded``)."""
    ids_shape = tuple(torch.as_tensor(input_ids).shape)
    mask_shape = tuple(torch.as_tensor(attention_mask).shape)
    if len(ids_shape) != 2 or ids_shape != mask_shape:
        raise ValueError(f"prefill takes [B, S] input_ids and an "
                         f"attention_mask of the same shape, got "
                         f"{list(ids_shape)} and {list(mask_shape)}")
    validate_left_padded(attention_mask)


def prefill_fn(model):
    """THE functional prefill contract (cache as explicit I/O):
    (params, input_ids, attention_mask) -> (last_logits, cache). The
    cache starts zeroed and holds the prompt at slots [0, S); its write
    index comes back as a host int."""

    def run(call, dev, input_ids, attention_mask):
        ids, mask, positions = _prompt(dev, input_ids, attention_mask)
        logits, cache = call(ids, mask, decode=True, positions=positions)
        return logits[:, -1, :], cache

    def check(params, input_ids, attention_mask):
        _check_prompt(input_ids, attention_mask)

    return _contract(model, run, (0,), check)


def _step_inputs(dev, token, position):
    return (torch.as_tensor(token, device=dev)[:, None],
            torch.as_tensor(position, device=dev)[:, None])


def decode_fn(model):
    """THE functional single-token decode contract:
    (params, cache, token, position) -> (logits, new_cache). ``cache``'s
    k/v/valid tensors are updated in place; the returned dict carries
    the advanced write index (advanced in place where it is a device
    tensor)."""

    def run(call, dev, cache, token, position):
        token, position = _step_inputs(dev, token, position)
        logits, cache = call(token, torch.ones_like(token), decode=True,
                             positions=position, cache=cache)
        return logits[:, -1, :], cache

    return _contract(model, run, (0, 1), cache_arg=1)


def _paged_view(dev, page_size, quantized, page_table, start, lens):
    from tpudl_torch.models.paged import PagedView

    def tensor(a):
        return torch.as_tensor(a, device=dev).long()

    return PagedView(tensor(page_table), tensor(start), tensor(lens),
                     page_size, quantized)


def _check_adapter_table(apools, atable) -> None:
    """The kernel reads the pages the table names unchecked: hold the
    host table to the pools' page range before it goes to the device."""
    from tpudl_torch.ops.segmented_lora import check_table

    site = next(iter(next(iter(apools.values())).values()))
    check_table(atable, site["a"].shape[0])


def _adapter_view(dev, apools, atable, ascale, impl):
    from tpudl_torch.models.lora import AdapterView
    from tpudl_torch.ops.norms import resolve_impl
    from tpudl_torch.ops.segmented_lora import batch_args

    table = torch.as_tensor(atable, device=dev, dtype=torch.int32)
    scale = torch.as_tensor(ascale, device=dev, dtype=torch.float32)
    # Held to the kernel's contract once for the dispatch's 7 x L calls.
    batch = batch_args(table, scale) if resolve_impl(impl, dev) else None
    return AdapterView(apools, table, scale, impl, batch)


def paged_decode_fn(model, page_size: int, quantized: bool = False):
    """THE paged single-token decode contract (tpudl_torch.models.paged):
    ``(params, cache, token, position, page_table, start, lens) ->
    (logits, cache)`` where ``cache`` holds per-layer page pools
    (``pages_k``/``pages_v``, written in place; with ``quantized``, int8
    pools and their ``scale_k``/``scale_v`` scale pools) and the three
    small int
    arrays are the host-owned addressing — the page table [B, P], the
    first attendable logical position [B] and the logical write position
    [B]. Built for the serve engine's paged mode
    (tpudl_torch.serve.cache.PagedKVCache owns the pools and the
    addressing)."""

    def run(call, dev, cache, token, position, page_table, start, lens):
        token, position = _step_inputs(dev, token, position)
        logits, cache = call(
            token, torch.ones_like(token), decode=True, positions=position,
            cache=cache, paged=_paged_view(dev, page_size, quantized,
                                           page_table, start, lens))
        return logits[:, -1, :], cache

    return _contract(model, run, (0, 1), cache_arg=1)


def _chunk_inputs(dev, tokens, positions):
    return (torch.as_tensor(tokens, device=dev),
            torch.as_tensor(positions, device=dev))


def chunk_prefill_fn(model):
    """THE suffix-prefill contract of prefix-sharing serving
    (tpudl_torch.serve.cache radix mode): ``(params, cache, tokens [B, C],
    positions [B, C]) -> (last_logits, cache)``. ``cache`` already holds
    the SHARED prefix KV (gathered out of radix-tree pages into dense
    rows, its device write index at the prefix length,
    ``PagedKVCache.gather_prefix_rows``); this runs only the C unshared
    suffix tokens through the dense decode branch, which writes the chunk
    at ``index .. index + C`` in place and attends slot-order-causally
    over prefix + chunk, so a prefill costs O(suffix). Positions are
    ABSOLUTE (token index in the unpadded prompt), keeping RoPE phases
    those of a cold full prefill. A captured call reads the cache in
    place and copies the tokens and positions in."""

    def run(call, dev, cache, tokens, positions):
        tokens, positions = _chunk_inputs(dev, tokens, positions)
        logits, cache = call(tokens, torch.ones_like(tokens), decode=True,
                             positions=positions, cache=cache)
        return logits[:, -1, :], cache

    return _contract(model, run, (0, 1), cache_arg=1)


def paged_chunk_decode_fn(model, page_size: int, quantized: bool = False):
    """THE speculative-verify contract: ``(params, cache, tokens [B, C],
    positions [B, C], page_table, start, lens) -> (logits [B, C, V],
    cache)``. One slot-batched call writes each slot's C-token window
    into its pages (token j at logical position ``lens + j``; past the
    table's capacity, into the trash page) and returns the logits of
    EVERY window position: the target model's verdict on all k draft
    proposals at once (tpudl_torch.serve.speculate). Causality within the
    window rides the chunked paged mask; a rejected tail rolls back on the
    host by not advancing ``lens`` past the emitted count."""

    def run(call, dev, cache, tokens, positions, page_table, start, lens):
        tokens, positions = _chunk_inputs(dev, tokens, positions)
        logits, cache = call(
            tokens, torch.ones_like(tokens), decode=True, positions=positions,
            cache=cache, paged=_paged_view(dev, page_size, quantized,
                                           page_table, start, lens))
        return logits, cache

    return _contract(model, run, (0, 1), cache_arg=1)


def lora_prefill_fn(model, impl: str = "auto"):
    """THE multi-tenant prefill contract: ``(params, input_ids,
    attention_mask, adapter_pools, adapter_table [1, r_max],
    adapter_scale [1]) -> (last_logits, cache)``: the batch-1 prefill
    with ONE tenant's adapter applied through the segmented-LoRA seam
    (tpudl_torch.models.lora.AdapterView). An all-zero table row (every
    entry on the never-written page 0) serves the plain base model, so
    tenantless requests take the same path. ``impl`` is the segmented
    kernel's dispatch seam. A captured call reads the pools in place and
    copies the table and scale in."""

    def run(call, dev, input_ids, attention_mask, apools, atable, ascale):
        ids, mask, positions = _prompt(dev, input_ids, attention_mask)
        logits, cache = call(
            ids, mask, decode=True, positions=positions,
            adapters=_adapter_view(dev, apools, atable, ascale, impl))
        return logits[:, -1, :], cache

    def check(params, input_ids, attention_mask, apools, atable, ascale):
        _check_prompt(input_ids, attention_mask)
        _check_adapter_table(apools, atable)

    return _contract(model, run, (0, 3), check)


def lora_paged_decode_fn(model, page_size: int, quantized: bool = False,
                         impl: str = "auto"):
    """THE multi-tenant paged decode contract: ``paged_decode_fn``'s seven
    arguments plus ``(adapter_pools, adapter_table [B, r_max],
    adapter_scale [B])``: every slot applies ITS tenant's adapter pages
    through one segmented-LoRA call per projection site
    (tpudl_torch.ops.segmented_lora). Slots with no tenant carry an
    all-zero table row and decode the plain base model."""

    def run(call, dev, cache, token, position, page_table, start, lens,
            apools, atable, ascale):
        token, position = _step_inputs(dev, token, position)
        logits, cache = call(
            token, torch.ones_like(token), decode=True, positions=position,
            cache=cache,
            paged=_paged_view(dev, page_size, quantized, page_table, start,
                              lens),
            adapters=_adapter_view(dev, apools, atable, ascale, impl))
        return logits[:, -1, :], cache

    def check(params, cache, token, position, page_table, start, lens,
              apools, atable, ascale):
        _check_adapter_table(apools, atable)

    return _contract(model, run, (0, 1, 7), check, cache_arg=1)


_NEG_INF = -1e30


def validate_sampling(temperature, top_k, top_p) -> None:
    """Reject sampling-parameter combinations that would silently not do
    what was asked: top_k/top_p only apply to the categorical branch, so
    pairing them with greedy (temperature 0) is an error, not a no-op."""
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature > 0 (temperature=0.0 is "
            "greedy argmax and would silently ignore them)"
        )
    if top_k is not None and not 0 < top_k:
        raise ValueError(f"top_k must be positive, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def validate_left_padded(attention_mask) -> None:
    """Every mask row must be BINARY 0s then 1s with at least one real
    token (right padding would leave the final slot — whose logits seed
    generation — on a pad; a non-binary value would corrupt
    ``position = sum(mask)``). One host sync for all three checks."""
    m = torch.as_tensor(attention_mask)
    ok = (
        (m[:, 1:] >= m[:, :-1]).all()
        & (m.sum(-1) > 0).all()
        & ((m == 0) | (m == 1)).all()
    )
    if not bool(ok):
        raise ValueError(
            "ragged prompt batches are served LEFT-padded: every "
            "attention_mask row must be binary (0/1) 0s then 1s with at "
            "least one real token"
        )


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator):
    """A categorical draw per row of [B, V] logits by the Gumbel-max
    trick (how jax.random.categorical draws), with uniforms from
    ``generator``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _select_impl(logits, generator, temperature, top_k=None, top_p=None,
                 greedy=None):
    """Next-token selection on [B, V] logits, in f32: greedy at
    temperature 0, else categorical over temperature-scaled logits,
    optionally truncated to the top-k tokens and/or the top-p mass (the
    smallest probability-sorted prefix whose mass reaches p; the argmax
    always survives; tokens equal to the cutoff logit are kept).
    ``temperature`` and ``top_p`` may be numbers or f32 device scalars
    (``generate()`` passes device scalars, so one captured chunk serves
    every temperature and top-p); ``greedy`` makes the structural branch
    explicit then (None: derive it from a numeric ``temperature``)."""
    if greedy is None:
        greedy = temperature == 0.0
    logits = logits.float()
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1)[0][..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True)[0]
        probs = torch.softmax(sorted_desc, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        num_kept = keep_sorted.sum(-1, keepdim=True)  # >= 1
        v_cut = torch.gather(sorted_desc, -1, num_kept - 1)
        logits = torch.where(logits >= v_cut, logits, _NEG_INF)
    return gumbel_argmax(logits, generator)


class _ChunkState:
    """What the chunked decode carries from chunk to chunk, in tensors a
    captured chunk reads and writes in place: the cache (k/v/valid per
    layer and one device write index they share), the last token, the
    next position and the done flags per row, and the sampling scalars
    (temperature, top-p, eos id) as f32 / int64 device scalars. On the
    card one state per (model, batch) lives on the model with the chunk
    graphs that read it (``model._decode_chunks``)."""

    def __init__(self, model, b, dev):
        from tpudl_torch.models.llama import init_cache

        self.cache = init_cache(model.cfg, b, device=dev)
        index = torch.zeros((), dtype=torch.int64, device=dev)
        for layer in self.cache["model"].values():
            layer["attention"]["index"] = index
        self.index = index
        self.token = torch.zeros(b, dtype=torch.int64, device=dev)
        self.position = torch.zeros(b, dtype=torch.int64, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.top_p = torch.ones((), dtype=torch.float32, device=dev)
        self.eos = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs = None
        self.params = None

    def load(self, cache, token, position, done, temperature, top_p,
             eos_id) -> None:
        """Copy a prefill's cache (host write index) and the first
        token's carry in."""
        from tpudl_torch.serve.cache import _zip_leaves

        for mine, theirs in _zip_leaves(self.cache, cache):
            if isinstance(mine, torch.Tensor) and mine is not self.index:
                mine.copy_(theirs)
        self.index.fill_(cache["model"]["layer_0"]["attention"]["index"])
        self.token.copy_(token)
        self.position.copy_(position)
        self.done.copy_(done)
        self.temperature.fill_(temperature)
        self.top_p.fill_(1.0 if top_p is None else top_p)
        self.eos.fill_(0 if eos_id is None else eos_id)


def _chunk_body(decode, params, state, steps, greedy, top_k, has_top_p,
                has_eos, generator):
    """``steps`` decode iterations from ``state`` (tpudl's
    ``_decode_chunk`` scan body, unrolled): decode the last token at its
    position, advance the position, select, eos-mask, emit. The state is
    written back in place; returns the chunk's [B, steps] tokens and the
    all-rows-done flag, computed here so the host reads one scalar a
    chunk. No host reads: the same body runs eagerly and captured."""
    token, position, done = state.token, state.position, state.done
    toks = []
    for _ in range(steps):
        logits, _ = decode.body(params, state.cache, token, position)
        position = position + 1
        token = _select_impl(logits, generator, state.temperature, top_k,
                             state.top_p if has_top_p else None,
                             greedy=greedy)
        if has_eos:
            token = torch.where(done, state.eos, token)
            done = done | (token == state.eos)
        toks.append(token)
    state.token.copy_(token)
    state.position.copy_(position)
    state.done.copy_(done)
    return torch.stack(toks, dim=1), done.all()


def _decode_chunk(decode, params, state, steps, greedy, top_k, has_top_p,
                  has_eos, generator):
    """One chunk of ``generate()``'s decode loop: on the card a CUDA graph
    per (batch, chunk length, greedy, top-k, top-p and eos switches),
    whose first chunk runs eagerly, second captures and every later one
    replays (tpudl_torch.graphs.KeyedGraphs, the step generator
    registered with each capture); on the CPU the body eagerly. Returns
    ``(tokens [B, steps], all_done)``, which the next chunk rewrites on
    the card."""
    key = (steps, greedy, top_k, has_top_p, has_eos)
    args = (decode, params, state, steps, greedy, top_k, has_top_p, has_eos)
    if state.graphs is None:
        return _chunk_body(*args, generator)
    return state.graphs.run(
        key, lambda gen: _chunk_body(*args, gen), generator)


def _chunk_state(model, params, b, dev) -> _ChunkState:
    if dev.type != "cuda":
        return _ChunkState(model, b, dev)
    from tpudl_torch.graphs import KeyedGraphs, _same_storage

    states = model.__dict__.setdefault("_decode_chunks", {})
    state = states.get(b)
    if state is None:
        state = states[b] = _ChunkState(model, b, dev)
    if state.graphs is None or not _same_storage(state.params, params):
        # The graphs read the weights in place: new weights, new graphs.
        state.graphs = KeyedGraphs(dev)
    state.params = params
    return state


def chunk_graphs(model) -> int:
    """How many chunk graphs ``generate()`` has captured on ``model``."""
    return sum(len(s.graphs.graphs)
               for s in getattr(model, "_decode_chunks", {}).values()
               if s.graphs is not None)


@torch.no_grad()
def generate(
    model,
    params,
    input_ids,
    attention_mask=None,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    eos_check_every: int = 8,
    chunked: bool = True,
) -> torch.Tensor:
    """Generate continuations for a [B, S] prompt batch.

    ``model`` is a LlamaForCausalLM whose config ``max_seq_len`` bounds
    S + max_new_tokens. Ragged prompts batch via LEFT-padding with
    ``attention_mask`` (0 = pad). Returns [B, max_new_tokens] token ids
    (int32, on the params' device; after ``eos_id``, rows are padded
    with eos). ``generator`` (default: seed 0 on the params' device)
    drives sampling; ``eos_check_every`` paces the all-rows-done
    readback (1 = check every token).

    The decode loop runs in chunks of ``eos_check_every`` tokens
    (``_decode_chunk``; tpudl's ``lax.scan`` chunks), each a CUDA graph
    on the card, with the one all-rows-done readback a chunk, after the
    first token and after each chunk (a batch done at its first token
    runs no chunk). ``chunked=False`` runs the per-token loop instead
    (a decode call, a selection and an eos update a token, and the
    readback every ``eos_check_every`` tokens), which gives the same
    tokens bit for bit: both draw from ``generator`` in the same order,
    with temperature, top-p and eos id as the same device scalars."""
    dev = params_device(params)
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, s = input_ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    validate_sampling(temperature, top_k, top_p)
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    else:
        attention_mask = torch.as_tensor(attention_mask, device=dev)
        validate_left_padded(attention_mask)
    if eos_check_every < 1:
        raise ValueError(
            f"eos_check_every must be >= 1 (1 = check every token), got "
            f"{eos_check_every}"
        )
    if s + max_new_tokens > model.cfg.max_seq_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len {model.cfg.max_seq_len} (the KV cache bound)"
        )
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    logits, cache = prefill_fn(model).body(params, input_ids, attention_mask)
    # Next absolute position per row (mask-aware: left padding skipped).
    position = attention_mask.sum(-1)
    greedy = temperature == 0.0
    state = (_chunk_state(model, params, b, dev) if chunked
             else _ChunkState(model, b, dev))
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    state.load(cache, 0, position, done, temperature, top_p, eos_id)
    del cache
    token = _select_impl(logits, generator, state.temperature, top_k,
                         state.top_p if top_p is not None else None,
                         greedy=greedy)
    if eos_id is not None:
        token = torch.where(done, state.eos, token)
        done = done | (token == state.eos)
    state.token.copy_(token)
    state.done.copy_(done)
    decode = decode_fn(model)
    out = [token[:, None]]
    if not chunked:
        return _per_token(decode, params, state, out, b, max_new_tokens,
                          greedy, top_k, top_p, eos_id, generator,
                          eos_check_every)
    remaining = max_new_tokens - 1
    all_done = eos_id is not None and bool(done.all())
    while remaining > 0:
        if all_done:
            # Every row finished: pad the rest with eos, skip dead steps.
            out.append(torch.full((b, remaining), eos_id,
                                  dtype=token.dtype, device=dev))
            break
        steps = min(eos_check_every, remaining)
        toks, all_done_op = _decode_chunk(
            decode, params, state, steps, greedy, top_k, top_p is not None,
            eos_id is not None, generator)
        out.append(toks.clone())
        remaining -= steps
        all_done = (remaining > 0 and eos_id is not None
                    and bool(all_done_op))
    return torch.cat(out, dim=1).to(torch.int32)


def _per_token(decode, params, state, out, b, max_new_tokens, greedy,
               top_k, top_p, eos_id, generator, eos_check_every):
    """``generate()``'s per-token loop (``chunked=False``) from the first
    token: one decode, selection and eos update a token, the
    all-rows-done readback after the first token and then every
    ``eos_check_every`` tokens."""
    token, position, done = state.token, state.position, state.done
    for t in range(1, max_new_tokens):
        if eos_id is not None and (t - 1) % eos_check_every == 0 and bool(
                done.all()):
            # Every row finished: pad the rest with eos, skip dead steps.
            out.append(torch.full((b, max_new_tokens - t), eos_id,
                                  dtype=token.dtype, device=token.device))
            break
        logits, _ = decode.body(params, state.cache, token, position)
        position = position + 1
        token = _select_impl(logits, generator, state.temperature, top_k,
                             state.top_p if top_p is not None else None,
                             greedy=greedy)
        if eos_id is not None:
            token = torch.where(done, state.eos, token)
            done = done | (token == state.eos)
        out.append(token[:, None])
    return torch.cat(out, dim=1).to(torch.int32)
