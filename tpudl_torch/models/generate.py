"""Autoregressive decoding with a KV cache (the Llama serving path).

The port's counterpart of tpudl.models.generate: the functional prefill
and single-token decode contracts the serving engine runs, and the
batched ``generate()`` loop. The contracts are plain functions (tpudl
jits them); ``params`` is the state_dict, bound into the model once
(tpudl_torch.models.llama.bind_params). Each decode contract also
carries its host checks, its device body and the arguments it reads in
place (``fn.check``, ``fn.body``, ``fn.static_args``), which is what
tpudl_torch.graphs.CapturedCall needs to capture it: the serving
engine's decode calls on the card are graphs. Prefill and
``generate()`` stay eager.

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


def prefill_fn(model):
    """THE functional prefill contract (cache as explicit I/O):
    (params, input_ids, attention_mask) -> (last_logits, cache). The
    cache starts zeroed and holds the prompt at slots [0, S)."""

    @torch.no_grad()
    def fn(params, input_ids, attention_mask):
        bind_params(model, params)
        dev = params_device(params)
        ids = torch.as_tensor(input_ids, device=dev)
        mask = torch.as_tensor(attention_mask, device=dev)
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        logits, cache = model(ids, mask, decode=True, positions=positions)
        return logits[:, -1, :], cache

    return fn


def _contract(body, static_args, check=None):
    """A decode contract: ``check`` (host checks) then ``body``, with both
    and ``static_args`` (the arguments a captured call reads in place)
    kept on the function for tpudl_torch.graphs.CapturedCall."""

    def fn(*args):
        fn.check(*args)
        return body(*args)

    fn.body = body
    fn.check = check or (lambda *args: None)
    fn.static_args = static_args
    return fn


def decode_fn(model):
    """THE functional single-token decode contract:
    (params, cache, token, position) -> (logits, new_cache). ``cache``'s
    k/v/valid tensors are updated in place; the returned dict carries
    the advanced write index (advanced in place where it is a device
    tensor)."""

    @torch.no_grad()
    def fn(params, cache, token, position):
        bind_params(model, params)
        dev = params_device(params)
        token = torch.as_tensor(token, device=dev)[:, None]
        position = torch.as_tensor(position, device=dev)[:, None]
        logits, cache = model(
            token, torch.ones_like(token), decode=True, positions=position,
            cache=cache,
        )
        return logits[:, -1, :], cache

    return _contract(fn, (0, 1))


def _paged_view(dev, page_size, page_table, start, lens):
    from tpudl_torch.models.paged import PagedView

    def tensor(a):
        return torch.as_tensor(a, device=dev).long()

    return PagedView(tensor(page_table), tensor(start), tensor(lens),
                     page_size)


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


def paged_decode_fn(model, page_size: int):
    """THE paged single-token decode contract (tpudl_torch.models.paged):
    ``(params, cache, token, position, page_table, start, lens) ->
    (logits, cache)`` where ``cache`` holds per-layer page pools
    (``pages_k``/``pages_v``, written in place) and the three small int
    arrays are the host-owned addressing — the page table [B, P], the
    first attendable logical position [B] and the logical write position
    [B]. Built for the serve engine's paged mode
    (tpudl_torch.serve.cache.PagedKVCache owns the pools and the
    addressing)."""

    @torch.no_grad()
    def fn(params, cache, token, position, page_table, start, lens):
        bind_params(model, params)
        dev = params_device(params)
        token = torch.as_tensor(token, device=dev)[:, None]
        position = torch.as_tensor(position, device=dev)[:, None]
        logits, cache = model(
            token, torch.ones_like(token), decode=True, positions=position,
            cache=cache, paged=_paged_view(dev, page_size, page_table, start,
                                           lens))
        return logits[:, -1, :], cache

    return _contract(fn, (0, 1))


def lora_prefill_fn(model, impl: str = "auto"):
    """THE multi-tenant prefill contract: ``(params, input_ids,
    attention_mask, adapter_pools, adapter_table [1, r_max],
    adapter_scale [1]) -> (last_logits, cache)``: the batch-1 prefill
    with ONE tenant's adapter applied through the segmented-LoRA seam
    (tpudl_torch.models.lora.AdapterView). An all-zero table row (every
    entry on the never-written page 0) serves the plain base model, so
    tenantless requests take the same path. ``impl`` is the segmented
    kernel's dispatch seam."""

    @torch.no_grad()
    def fn(params, input_ids, attention_mask, apools, atable, ascale):
        _check_adapter_table(apools, atable)
        bind_params(model, params)
        dev = params_device(params)
        ids = torch.as_tensor(input_ids, device=dev)
        mask = torch.as_tensor(attention_mask, device=dev)
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        logits, cache = model(
            ids, mask, decode=True, positions=positions,
            adapters=_adapter_view(dev, apools, atable, ascale, impl))
        return logits[:, -1, :], cache

    return fn


def lora_paged_decode_fn(model, page_size: int, impl: str = "auto"):
    """THE multi-tenant paged decode contract: ``paged_decode_fn``'s seven
    arguments plus ``(adapter_pools, adapter_table [B, r_max],
    adapter_scale [B])``: every slot applies ITS tenant's adapter pages
    through one segmented-LoRA call per projection site
    (tpudl_torch.ops.segmented_lora). Slots with no tenant carry an
    all-zero table row and decode the plain base model."""

    @torch.no_grad()
    def fn(params, cache, token, position, page_table, start, lens, apools,
           atable, ascale):
        bind_params(model, params)
        dev = params_device(params)
        token = torch.as_tensor(token, device=dev)[:, None]
        position = torch.as_tensor(position, device=dev)[:, None]
        logits, cache = model(
            token, torch.ones_like(token), decode=True, positions=position,
            cache=cache,
            paged=_paged_view(dev, page_size, page_table, start, lens),
            adapters=_adapter_view(dev, apools, atable, ascale, impl))
        return logits[:, -1, :], cache

    def check(params, cache, token, position, page_table, start, lens,
              apools, atable, ascale):
        _check_adapter_table(apools, atable)

    return _contract(fn, (0, 1, 7), check)


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


def _select_impl(logits, generator, temperature, top_k=None, top_p=None):
    """Next-token selection on [B, V] logits, in f32: greedy at
    temperature 0, else categorical over temperature-scaled logits,
    optionally truncated to the top-k tokens and/or the top-p mass (the
    smallest probability-sorted prefix whose mass reaches p; the argmax
    always survives; tokens equal to the cutoff logit are kept)."""
    logits = logits.float()
    if temperature == 0.0:
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
) -> torch.Tensor:
    """Generate continuations for a [B, S] prompt batch.

    ``model`` is a LlamaForCausalLM whose config ``max_seq_len`` bounds
    S + max_new_tokens. Ragged prompts batch via LEFT-padding with
    ``attention_mask`` (0 = pad). Returns [B, max_new_tokens] token ids
    (int32, on the params' device; after ``eos_id``, rows are padded
    with eos). ``generator`` (default: seed 0 on the params' device)
    drives sampling; ``eos_check_every`` paces the all-rows-done
    readback (1 = check every token)."""
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

    logits, cache = prefill_fn(model)(params, input_ids, attention_mask)
    # Next absolute position per row (mask-aware: left padding skipped).
    position = attention_mask.sum(-1)
    decode = decode_fn(model)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = []
    for t in range(max_new_tokens):
        if t:
            logits, cache = decode(params, cache, token, position)
            position = position + 1
        token = _select_impl(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        out.append(token[:, None])
        if (
            eos_id is not None
            and t % eos_check_every == 0
            and t + 1 < max_new_tokens
            and bool(done.all())
        ):
            # Every row finished: pad the rest with eos, skip dead steps.
            out.append(torch.full((b, max_new_tokens - t - 1), eos_id,
                                  dtype=token.dtype, device=dev))
            break
    tokens = torch.cat(out, dim=1)
    return tokens.to(torch.int32)
