"""Serving export of the autoregressive decode path: the port's
counterpart of tpudl.export.decode.

The prefill and single-token decode contracts of
tpudl_torch.models.generate are exported as ``torch.export`` programs
with the parameters and the KV cache as explicit inputs and outputs,
traced from the contracts themselves (their ``functional`` form: one
definition, so an artifact cannot part from ``generate()``):

- prefill: ``(params, input_ids, attention_mask) -> (last_logits,
  cache)``, the cache's write index a host int;
- decode: ``(params, cache, token, position) -> (logits, cache)``, the
  cache written in place, its write index one 0-d device tensor every
  layer shares (the serving engine's SlotCache layout);
- paged decode: ``(params, cache, token, position, page_table, start,
  lens) -> (logits, cache)`` over the page pools of a PagedKVCache
  (``kv_dtype="int8"``: int8 pools and their scale pools).

A quantized model (tpudl_torch.quant.quantize_model) exports as it is:
its ``qvalues`` / ``qscale`` buffers are inputs like any parameter, and
its products are ``tpudl::quant_dot`` nodes.

Token ids, masks, positions and the paged addressing are int32, as the
serving engine passes them. ``generate_with_exported`` reproduces
greedy ``generate()`` from the loaded programs alone.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from tpudl_torch.export.export import (
    export_program,
    input_values,
    load_exported,
)
from tpudl_torch.models.generate import (  # noqa: F401
    decode_fn,
    paged_decode_fn,
    prefill_fn,
    validate_left_padded,
)
from tpudl_torch.models.llama import init_cache, params_device


def device_index_cache(cache: dict) -> dict:
    """A prefill's cache (host write index) in the decode artifacts'
    layout: the same k/v/valid tensors, one 0-d int64 device index that
    every layer shares."""
    layers = cache["model"]
    first = layers["layer_0"]["attention"]
    index = torch.tensor(int(first["index"]), dtype=torch.int64,
                         device=first["k"].device)
    return {"model": {name: {"attention": {**layer["attention"],
                                            "index": index}}
                      for name, layer in layers.items()}}


def _prompt_args(batch, prompt_len, dev):
    ids = torch.zeros((batch, prompt_len), dtype=torch.int32, device=dev)
    return ids, torch.ones_like(ids)


def _step_args(batch, prompt_len, dev):
    token = torch.zeros((batch,), dtype=torch.int32, device=dev)
    return token, torch.full((batch,), prompt_len, dtype=torch.int32,
                             device=dev)


def _dense_cache(model, batch, dev):
    from tpudl_torch.serve.cache import SlotCache

    return SlotCache(init_cache(model.cfg, batch, device="meta"),
                     device=dev).cache


def export_decoder(model, params, batch_size: int, prompt_len: int,
                   path_prefix: Optional[str] = None,
                   decode_batch_size: Optional[int] = None
                   ) -> Tuple[bytes, bytes]:
    """Export (prefill, decode) artifacts at fixed ``batch_size`` /
    ``prompt_len`` (static shapes are the serving contract; the cache is
    bounded by ``model.cfg.max_seq_len``). ``decode_batch_size`` gives
    the decode program another batch than the prefill (the engine
    prefills one request at a time into a slot-batched decode: see
    ``export_serving_decoder``). With ``path_prefix``, writes
    ``{prefix}.prefill.pt2`` and ``{prefix}.decode.pt2``."""
    if decode_batch_size is None:
        decode_batch_size = batch_size
    dev = params_device(params)
    prefill_blob = export_program(
        prefill_fn(model), (params, *_prompt_args(batch_size, prompt_len,
                                                  dev)),
        path=f"{path_prefix}.prefill.pt2" if path_prefix else None)
    decode_blob = export_program(
        decode_fn(model),
        (params, _dense_cache(model, decode_batch_size, dev),
         *_step_args(decode_batch_size, prompt_len, dev)),
        path=f"{path_prefix}.decode.pt2" if path_prefix else None)
    return prefill_blob, decode_blob


def export_serving_decoder(model, params, num_slots: int, prompt_len: int,
                           path_prefix: Optional[str] = None,
                           paged: bool = False, page_size: int = 16,
                           num_pages: Optional[int] = None,
                           kv_dtype: Optional[str] = None
                           ) -> Tuple[bytes, bytes]:
    """The artifact pair the continuous-batching engine serves: a
    batch-1 prefill and a batch-``num_slots`` decode.
    ``ServeSession.from_artifacts`` recovers every shape it needs from
    them, with no side-channel metadata. ``paged=True`` exports the paged
    decode contract over a PagedKVCache of ``page_size`` / ``num_pages``
    (the page table, start and lens ride as int32 inputs, so seating and
    freeing never need another program); ``kv_dtype="int8"`` exports it
    over int8 pools."""
    if kv_dtype is not None and not paged:
        raise ValueError("kv_dtype requires paged=True")
    if not paged:
        return export_decoder(model, params, 1, prompt_len,
                              path_prefix=path_prefix,
                              decode_batch_size=num_slots)
    from tpudl_torch.serve.cache import PagedKVCache

    dev = params_device(params)
    cache = PagedKVCache(init_cache(model.cfg, num_slots, device="meta"),
                         page_size=page_size, num_pages=num_pages,
                         kv_dtype=kv_dtype, device=dev)
    addressing = tuple(torch.as_tensor(a, device=dev)
                       for a in cache.dispatch_args())
    prefill_blob = export_program(
        prefill_fn(model), (params, *_prompt_args(1, prompt_len, dev)),
        path=f"{path_prefix}.prefill.pt2" if path_prefix else None)
    decode_blob = export_program(
        paged_decode_fn(model, cache.page_size, cache.quantized),
        (params, cache.cache, *_step_args(num_slots, prompt_len, dev),
         *addressing),
        path=f"{path_prefix}.decode.pt2" if path_prefix else None)
    return prefill_blob, decode_blob


@torch.no_grad()
def generate_with_exported(prefill_call: Callable, decode_call: Callable,
                           params, input_ids, attention_mask=None,
                           max_new_tokens: int = 32,
                           eos_id: Optional[int] = None,
                           max_seq_len: Optional[int] = None,
                           eos_check_every: int = 8) -> torch.Tensor:
    """Greedy generation driven by loaded artifacts alone (the
    reference's session.run loop). Ragged prompt batches ride
    LEFT-padded through ``attention_mask`` (0 = pad). Returns [B,
    max_new_tokens] int32 token ids, eos-padded like ``generate()``.

    ``max_seq_len`` is the exporting model's cache bound; a loaded
    program cannot see it, so pass it on serving paths. The
    all-rows-done readback runs after the first token and then every
    ``eos_check_every`` tokens; a batch done early stops calling decode
    and pads with eos."""
    dev = params_device(params)
    input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int32)
    b, s = input_ids.shape
    if eos_check_every < 1:
        raise ValueError(f"eos_check_every must be >= 1, got "
                         f"{eos_check_every}")
    if max_seq_len is not None and s + max_new_tokens > max_seq_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"exporting model's KV-cache bound max_seq_len={max_seq_len}")
    if attention_mask is None:
        mask = torch.ones_like(input_ids)
    else:
        mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)
        validate_left_padded(mask)
    logits, cache = prefill_call(params, input_ids, mask)
    cache = device_index_cache(cache)
    position = mask.sum(-1).to(torch.int32)
    token = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    tokens = []
    for i in range(max_new_tokens):
        if eos_id is not None:
            token = torch.where(done, eos_id, token)
            done = done | (token == eos_id)
        tokens.append(token)
        if i + 1 == max_new_tokens:
            break
        if (eos_id is not None and (i == 0 or (i + 1) % eos_check_every == 0)
                and bool(done.all())):
            # Every row finished: the rest is eos by contract.
            break
        logits, _ = decode_call(params, cache, token, position)
        position = position + 1
        token = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    out = torch.stack(tokens, dim=1)
    if out.shape[1] < max_new_tokens:
        pad = torch.full((b, max_new_tokens - out.shape[1]), eos_id,
                         dtype=out.dtype, device=dev)
        out = torch.cat([out, pad], dim=1)
    return out


def load_decoder(prefill_blob_or_path, decode_blob_or_path, device=None
                 ) -> Tuple[Callable, Callable]:
    """Deserialize the (prefill, decode) artifact pair into callables
    (``device`` moves them there)."""
    return (load_exported(prefill_blob_or_path, device),
            load_exported(decode_blob_or_path, device))


def artifact_call(program, static_args, cache_arg, device) -> Callable:
    """A loaded serving program as a contract of
    tpudl_torch.models.generate: ``fn(*args)`` with ``fn.body``,
    ``fn.check``, ``fn.static_args`` and ``fn.cache_arg``, so the engine
    calls it and tpudl_torch.graphs.CapturedCall captures it as it does
    the live contracts. Host arguments (the engine's int32 arrays) become
    tensors of the program's input dtypes on ``device``; a decode call
    returns its cache argument, which the program wrote in place."""
    module = program.module()
    specs = input_values(program)[0]

    def body(*args):
        args = [a if i in static_args else torch.as_tensor(
            a, device=device).to(specs[i].dtype) for i, a in enumerate(args)]
        logits, cache = module(*args)
        return logits, cache if cache_arg is None else args[cache_arg]

    def check(*args):
        if cache_arg is None:
            validate_left_padded(args[2])

    def fn(*args):
        check(*args)
        return body(*args)

    fn.body, fn.check = body, check
    fn.static_args, fn.cache_arg = static_args, cache_arg
    return fn
