"""Llama-family decoder (RoPE + RMSNorm + SwiGLU + GQA) in PyTorch: the
dense and paged decode paths, the non-decode forward, the LoRA
classifier and the multi-tenant adapter hooks.

The port's counterpart of tpudl.models.llama. Serving applies the model
with ``decode=True`` for prefill and decode alike (the dense KV-cache
branch of ``LlamaAttention``, or with ``paged=`` a
tpudl_torch.models.paged.PagedView, the paged branch: k/v written into
and gathered from page pools by a host-owned page table, each slot at
its own length). ``adapters=`` (a tpudl_torch.models.lora.AdapterView)
adds each slot's own LoRA delta after every projection (q/k/v/o,
gate/up/down) through one segmented-LoRA call per site, the base
weights resident once. Training applies it with ``decode=False``
(GQA heads expanded with ``repeat_interleave``, as ``jnp.repeat``, then
``attend`` with the causal flag and ``cfg.attention_impl``: "flash" runs
the flash-attention kernels). ``LlamaForSequenceClassification`` pools
the last non-pad token into an f32 classifier with a bias.
``cfg.lora_rank > 0`` makes every projection a
tpudl_torch.models.lora.LoRALinear. ``cfg.remat`` recomputes each block
of the non-decode forward in the backward (tpudl_torch.models.remat; the
decode paths never remat, as tpudl's). ``cfg.fp8_train`` makes the seven
projections of every block tpudl_torch.ops.fp8_dot.Fp8Dense (tpudl's
``_proj``): e4m3 forward and e5m2 gradient products with delayed
scaling, composing with ``lora_rank`` (the adapters run in ``cfg.dtype``
on top of the fp8 base product); it excludes ``weight_dtype``.
``cfg.weight_dtype`` ("int8", "fp8_e4m3") makes the same seven sites
tpudl_torch.quant.dense.QuantDense (``LoRALinear`` with adapters), which
serve a state_dict tpudl_torch.quant.quantize_model quantized through the
hand-written weight-only product and run a full-precision one with the
plain projection's exact math. ``cfg.moe_experts > 0`` swaps every
block's SwiGLU MLP for tpudl_torch.ops.moe.MoEMlp (gated, ``moe_k``
choices, ``moe_capacity_factor``), whose aux loss the train step reads
(``moe_aux_weight``).

Numerics follow the JAX model: projections and the embedding compute in
``cfg.dtype``, RMSNorm statistics in f32, RoPE angles in f32, attention
logits and softmax in f32, and the ``lm_head`` and classifier in full
f32 (TF32 off). With ``cfg.fused_ops`` (default True here) the norms and
the SwiGLU go through the Hopper kernels of tpudl_torch.ops on CUDA
tensors (forward and backward).

Serving models (``LlamaForCausalLM``) and adapter models (``lora_rank``
> 0) keep their frozen base weights (projections, embedding) in the
compute dtype, which gives the numbers of tpudl's f32 masters cast at
use (``nn.Dense(dtype=bf16)`` casts its kernel, ``nn.Embed(dtype=bf16)``
its table) at half the bytes; training updates the adapters and the
classifier (``lora_optimizer``). ``LlamaForSequenceClassification`` with
``lora_rank=0`` trains every parameter, as tpudl does: its projections
and embedding are f32 masters cast to ``cfg.dtype`` at use (their
gradients come back through the cast in f32). ``tpudl_path`` maps a
parameter name to its tpudl tree path (the inverse of
``params_from_tpudl``), which the precision rules match.

Parameters mirror tpudl's tree: ``model.layer_{i}.attention.q_proj.weight``
holds tpudl's ``model/layer_{i}/attention/q_proj/kernel`` transposed
(``[out, in]``, the torch Linear layout); ``params_from_tpudl`` converts a
tpudl params tree, ``init_params`` draws a fresh one from a
``torch.Generator`` the way ``model.init`` does.

The KV cache is an explicit dict in the layout of tpudl's flax ``cache``
collection: ``cache["model"]["layer_{i}"]["attention"]`` holds ``k``,
``v`` ([B, max_seq_len, Hkv, D]), ``valid`` ([B, max_seq_len] bool) and
``index`` (the shared write position). Unlike JAX, the forward writes
``k``/``v``/``valid`` IN PLACE (no cache-sized copy per step). A host
int ``index`` (a fresh cache, prefill, ``generate()``) comes back
advanced in a new dict; a 0-d int64 device tensor (one tensor shared by
every layer: the serving engine's ``SlotCache``) is advanced in place,
and the rows go in by ``index_copy_`` at the slots it names, so a
captured decode step writes each replay's own slots. The horizon of a
device index is its owner's to check, on the host.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudl_torch.models.bert import Dense
from tpudl_torch.models.lora import LoRALinear, adapter_delta, is_lora_param
from tpudl_torch.models.paged import (
    paged_attend_mask,
    paged_gather,
    paged_write,
)
from tpudl_torch.models.remat import checkpointed
from tpudl_torch.ops.attention import MASK_VALUE, attend
from tpudl_torch.ops.fp8_dot import Fp8Dense, fp8_train_impl
from tpudl_torch.ops.mlp_fused import swiglu
from tpudl_torch.ops.moe import MoEMlp
from tpudl_torch.ops.norms import fused_ops_impl, rms_norm
from tpudl_torch.quant.dense import QuantDense
from tpudl_torch.quant.quantize import quantized_tensor, validate_weight_dtype


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    rms_norm_eps: float = 1e-5
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16
    #: The non-decode forward's ``attend`` implementation ("reference",
    #: "flash"; "fused" is flash past S = 512).
    attention_impl: str = "reference"
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # Kernel tier: False = plain PyTorch norms/SwiGLU everywhere; True
    # (the default here) = the Hopper kernels on CUDA tensors, the plain
    # versions on CPU tensors; "force" = the kernels or an error.
    fused_ops: Any = True
    #: Recompute each block of the non-decode forward in the backward.
    remat: bool = False
    #: Serving weight storage of the seven projections: None, "int8",
    #: "fp8_e4m3" (tpudl_torch.quant).
    weight_dtype: Optional[str] = None
    #: > 0 swaps every block's MLP for a gated MoE of this many experts.
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    #: fp8 training products at the seven projections: False, True /
    #: "auto", "reference", "force" / "fused" (tpudl_torch.ops.fp8_dot
    #: .fp8_train_impl).
    fp8_train: Any = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


LLAMA_TINY = partial(
    LlamaConfig,
    vocab_size=512,
    hidden_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    intermediate_size=256,
    max_seq_len=256,
    rope_theta=10_000.0,
)
LLAMA3_8B = LlamaConfig
#: Llama-3.2-1B shape.
LLAMA3_1B = partial(
    LlamaConfig,
    hidden_size=2048,
    num_layers=16,
    num_heads=32,
    num_kv_heads=8,
    intermediate_size=8192,
)

LLAMA_SIZES = {
    "llama-tiny": LLAMA_TINY,
    "llama3-1b": LLAMA3_1B,
    "llama3-8b": LLAMA3_8B,
}

def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.lora_rank < 0:
        raise ValueError(f"lora_rank must be >= 0 (0 = adapters off), got "
                         f"{cfg.lora_rank}")
    if cfg.fp8_train and cfg.weight_dtype is not None:
        raise ValueError(
            "fp8_train (training-time fp8 matmuls) does not compose "
            "with weight_dtype (frozen-tree serving quantization) "
            "— pick one")
    if cfg.weight_dtype is not None:
        validate_weight_dtype(cfg.weight_dtype)
    if cfg.moe_experts < 0:
        raise ValueError(f"moe_experts must be >= 0, got {cfg.moe_experts}")


class RMSNorm(nn.Module):
    """RMS normalization through the tpudl_torch.ops.norms seam; with
    ``residual=`` it returns ``(normed, x + residual)`` from one pass."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 impl: str = "reference", device=None):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.scale = nn.Parameter(
            torch.ones(hidden_size, dtype=torch.float32, device=device)
        )

    def forward(self, x, residual=None):
        return rms_norm(x, self.scale, residual, eps=self.eps, impl=self.impl)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary phases for ``positions`` [B, S], in f32,
    shaped [B, S, 1, head_dim/2] to broadcast over heads. Computed once
    per forward and shared by every layer's q and k."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=positions.device) / head_dim)
    )
    angles = positions[:, :, None].float() * inv_freq
    return angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate-half RoPE on [B, S, H, D] with precomputed phases: f32
    math, cast back to ``x``'s dtype (tpudl.models.llama.rope)."""
    d = x.shape[-1]
    x1 = x[..., : d // 2].float()
    x2 = x[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding on [B, S, H, D] (rotate-half convention) — the
    counterpart of tpudl.models.llama.rope."""
    return apply_rope(x, *rope_angles(positions, x.shape[-1], theta))


def _gqa_decode_attention(q, k, v, mask):
    """Decode-path attention with query heads grouped over shared KV
    heads. q: [B, S, H, D]; k, v: [B, T, Hkv, D]; mask: [B, 1, S, T]
    (True = attend). Query head h uses kv head h // (H / Hkv)
    (consecutive groups). f32 logits and softmax."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (d ** -0.5)
    logits = logits.float()
    logits = torch.where(mask[:, :, None, :, :], logits, MASK_VALUE)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhgqk,bkhd->bqhgd", weights, v)
    return ctx.reshape(b, s, h, d)


def _linear(cfg, d_in, d_out, device, masters=False):
    """A projection (tpudl's ``_proj``): Fp8Dense with ``fp8_train``
    (adapters on it with ``lora_rank``), LoRALinear with adapters on (its
    base may be bound quantized), QuantDense with ``weight_dtype``, else a
    bias-free Linear. ``masters``: the weight is an f32 master cast at use
    (a trainable base; BERT's ``Dense`` without a bias) rather than a
    frozen compute-dtype copy."""
    if cfg.fp8_train:
        return Fp8Dense(d_in, d_out, cfg.dtype, use_bias=False,
                        rank=cfg.lora_rank, alpha=cfg.lora_alpha,
                        impl=fp8_train_impl(cfg.fp8_train),
                        weight_dtype=torch.float32 if masters else cfg.dtype,
                        device=device)
    if cfg.lora_rank > 0:
        return LoRALinear(d_in, d_out, cfg.lora_rank, cfg.lora_alpha,
                          cfg.dtype, device)
    if cfg.weight_dtype is not None:
        return QuantDense(d_in, d_out, cfg.dtype, device, masters=masters)
    if masters:
        return Dense(d_in, d_out, cfg.dtype, device, use_bias=False)
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=cfg.dtype)


def _adapted(y, adapters, site, x):
    """``y`` plus the multi-tenant adapter delta of ``site`` (tpudl's
    ``y + adapter_delta(...)``, the add done by the same segmented-LoRA
    call); ``y`` itself, with no extra pass, where no view or no pool
    adapts the site."""
    return adapter_delta(adapters, site, x, base=y)


def init_cache(cfg: LlamaConfig, batch_size: int, device="cuda") -> dict:
    """A zeroed decode cache for ``batch_size`` rows (all slots invalid,
    write index 0) — what tpudl's flax cache collection starts as.
    ``device="meta"`` gives a shape-only template."""
    shape = (batch_size, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)

    def layer():
        return {"attention": {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "valid": torch.zeros((batch_size, cfg.max_seq_len),
                                 dtype=torch.bool, device=device),
            "index": 0,
        }}

    return {"model": {f"layer_{i}": layer() for i in range(cfg.num_layers)}}


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, masters=False):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        h, q, kv = cfg.hidden_size, cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.q_proj = _linear(cfg, h, q, device, masters)
        self.k_proj = _linear(cfg, h, kv, device, masters)
        self.v_proj = _linear(cfg, h, kv, device, masters)
        self.o_proj = _linear(cfg, q, h, device, masters)

    def forward(self, hidden, rope_cs, causal, kv_mask, cache, paged=None,
                adapters=None):
        """With a ``cache`` (this layer's dict) and a ``paged`` view
        (tpudl_torch.models.paged), the paged decode branch: write this
        chunk's k/v into the pool pages the view addresses, attend to each
        slot's logical positions [start, lens + j]. With a ``cache`` and
        no view, the dense decode branch: write this chunk's
        k/v/validity at the cache's write index, attend to slots that are
        causally prior in WRITE order and valid; ``causal`` is the [1, 1,
        S, T] slot-order triangle for this chunk. Without a cache, the
        non-decode branch: kv heads expanded to the query heads, then
        ``attend`` with the [B, S] validity row and the causal flag;
        returns ``(out, None)``. ``adapters`` (this layer's AdapterView)
        adds each slot's own LoRA delta after every projection."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        hd = cfg.head_dim
        q = _adapted(self.q_proj(hidden), adapters, "q_proj", hidden)
        k = _adapted(self.k_proj(hidden), adapters, "k_proj", hidden)
        v = _adapted(self.v_proj(hidden), adapters, "v_proj", hidden)
        q = apply_rope(q.view(b, s, cfg.num_heads, hd), *rope_cs)
        k = apply_rope(k.view(b, s, cfg.num_kv_heads, hd), *rope_cs)
        v = v.view(b, s, cfg.num_kv_heads, hd)

        def out_proj(ctx):
            ctx = ctx.reshape(b, s, cfg.num_heads * hd)
            return _adapted(self.o_proj(ctx), adapters, "o_proj", ctx)

        if cache is None:
            if cfg.num_kv_heads != cfg.num_heads:
                reps = cfg.num_heads // cfg.num_kv_heads
                k = k.repeat_interleave(reps, dim=2)
                v = v.repeat_interleave(reps, dim=2)
            ctx = attend(q, k, v, mask=kv_mask, causal=True,
                         implementation=cfg.attention_impl)
            return out_proj(ctx), None
        if paged is not None:
            # Prefill stays dense batch-1; PagedKVCache.seat scatters its
            # row cache into pages. Chunks of any length step together.
            # An int8 pool quantizes on the write, dequantizes in the
            # gather; its scale pools are written in place too.
            pk, sk = paged_write(cache["pages_k"], cache.get("scale_k"), k,
                                 paged)
            pv, sv = paged_write(cache["pages_v"], cache.get("scale_v"), v,
                                 paged)
            ctx = _gqa_decode_attention(
                q, paged_gather(pk, sk, paged, k.dtype),
                paged_gather(pv, sv, paged, v.dtype),
                paged_attend_mask(paged, chunk=s))
            new = {"pages_k": pk, "pages_v": pv}
            if paged.quantized:
                new.update(scale_k=sk, scale_v=sv)
            return out_proj(ctx), new

        ck, cv, cvalid = cache["k"], cache["v"], cache["valid"]
        start = cache["index"]
        new_valid = (torch.ones((b, s), dtype=torch.bool, device=ck.device)
                     if kv_mask is None else kv_mask.bool())
        if isinstance(start, torch.Tensor):
            # A device write index (the serving engine's SlotCache): its
            # owner checked the horizon on the host, and the rows go in
            # by index, so a captured step writes each replay's own slots.
            # The model advances the index once all layers wrote.
            slots = start + torch.arange(s, device=ck.device)
            ck.index_copy_(1, slots, k.to(ck.dtype))
            cv.index_copy_(1, slots, v.to(cv.dtype))
            cvalid.index_copy_(1, slots, new_valid)
            index = start
        else:
            if start + s > ck.shape[1]:
                raise ValueError(
                    f"cache write [{start}, {start + s}) runs past "
                    f"max_seq_len {ck.shape[1]} (tpudl's "
                    f"dynamic_update_slice would clamp it onto the last "
                    f"slots and corrupt the cache)"
                )
            ck[:, start:start + s] = k
            cv[:, start:start + s] = v
            cvalid[:, start:start + s] = new_valid
            index = start + s
        mask = causal & cvalid[:, None, None, :]
        # Grouped-query attention against the UNEXPANDED cache.
        ctx = _gqa_decode_attention(q, ck, cv, mask)
        return out_proj(ctx), {"k": ck, "v": cv, "valid": cvalid,
                               "index": index}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, masters=False):
        super().__init__()
        _check_ported(cfg)
        self.is_moe = cfg.moe_experts > 0
        self.impl = fused_ops_impl(cfg.fused_ops)
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, self.impl, device)
        self.attention = LlamaAttention(cfg, device, masters)
        self.post_attention_norm = RMSNorm(h, cfg.rms_norm_eps, self.impl, device)
        if self.is_moe:
            self.moe = MoEMlp(h, cfg.moe_experts, f, k=cfg.moe_k,
                              capacity_factor=cfg.moe_capacity_factor,
                              gated=True, dtype=cfg.dtype,
                              param_dtype=torch.float32 if masters
                              else cfg.dtype, device=device)
            return
        self.gate_proj = _linear(cfg, h, f, device, masters)
        self.up_proj = _linear(cfg, h, f, device, masters)
        self.down_proj = _linear(cfg, f, h, device, masters)

    def forward(self, hidden, rope_cs, causal, kv_mask, cache, paged=None,
                adapters=None):
        attn, attn_cache = self.attention(
            self.input_norm(hidden), rope_cs, causal, kv_mask,
            None if cache is None else cache["attention"], paged, adapters,
        )
        # The attention residual add rides inside the post-attention norm
        # kernel; the summed value comes back as the carried residual.
        x, hidden = self.post_attention_norm(attn, residual=hidden)
        if self.is_moe:
            out = hidden + self.moe(x)
            return out, None if cache is None else {"attention": attn_cache}
        gate = _adapted(self.gate_proj(x), adapters, "gate_proj", x)
        up = _adapted(self.up_proj(x), adapters, "up_proj", x)
        act = swiglu(gate, up, impl=self.impl)
        out = hidden + _adapted(self.down_proj(act), adapters, "down_proj",
                                act)
        return out, None if cache is None else {"attention": attn_cache}


class LlamaModel(nn.Module):
    """Decoder stack: embeddings + N blocks + final RMSNorm. ``masters``:
    the projections and the embedding are f32 masters cast to
    ``cfg.dtype`` at use (a trainable base), else stored in ``cfg.dtype``."""

    def __init__(self, cfg: LlamaConfig, device=None, masters=False):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, device=device,
            dtype=torch.float32 if masters else cfg.dtype,
        )
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, device, masters))
        self.final_norm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, fused_ops_impl(cfg.fused_ops),
            device,
        )

    def embed(self, input_ids):
        """The lookup from the table cast to ``cfg.dtype`` (flax
        ``nn.Embed(dtype=...)``; its backward sums in that dtype)."""
        return F.embedding(input_ids.long(),
                           self.embed_tokens.weight.to(self.cfg.dtype))

    def forward(self, input_ids, attention_mask=None, decode=False,
                positions=None, cache=None, paged=None, adapters=None):
        """``(hidden [B, S, hidden], cache)``: with ``decode``, the cache
        advanced by this chunk (a new zeroed one when ``cache`` is None;
        with a ``paged`` view, the page pools written in place); without,
        the non-decode forward and None. ``adapters`` (an AdapterView)
        applies each slot's adapter at every projection."""
        cfg = self.cfg

        def layer_view(i):
            return None if adapters is None else adapters.for_layer(
                f"layer_{i}")

        kv_mask = attention_mask
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if positions is None:
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        if not decode:
            x = self.embed(input_ids)
            rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            remat = cfg.remat and torch.is_grad_enabled()
            for i in range(cfg.num_layers):
                args = (x, rope_cs, None, kv_mask, None, None, layer_view(i))
                layer = getattr(self, f"layer_{i}")
                # The training forward draws no bits: no generator to keep.
                x, _ = (checkpointed(layer, None, *args) if remat
                        else layer(*args))
            return self.final_norm(x), None
        if paged is not None:
            if cache is None:
                raise ValueError(
                    "paged decode requires the page pools (the cache "
                    "tpudl_torch.serve.cache.PagedKVCache builds): there is "
                    "no shape information to make one here")
            x = self.embed(input_ids)
            rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            new_cache = {}
            for i in range(cfg.num_layers):
                name = f"layer_{i}"
                x, new_cache[name] = getattr(self, name)(
                    x, rope_cs, None, kv_mask, cache[name], paged,
                    layer_view(i))
            return self.final_norm(x), new_cache
        if cache is None:
            cache = init_cache(cfg, input_ids.shape[0],
                               self.embed_tokens.weight.device)["model"]
        x = self.embed(input_ids)
        s = input_ids.shape[1]
        start = cache["layer_0"]["attention"]["index"]
        device_index = isinstance(start, torch.Tensor)
        indices = [cache[f"layer_{i}"]["attention"]["index"]
                   for i in range(cfg.num_layers)]
        # A device index is one tensor that every layer shares.
        if any(i is not start if device_index else i != start
               for i in indices):
            raise ValueError("cache layers disagree on the write index")
        # Slot-order causality for this chunk (shared by every layer; the
        # per-layer validity row is ANDed in by each attention).
        kv_slot = torch.arange(cfg.max_seq_len, device=x.device)
        q_slot = start + torch.arange(s, device=x.device)
        causal = (kv_slot[None, :] <= q_slot[:, None])[None, None]
        rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        new_cache = {}
        for i in range(cfg.num_layers):
            name = f"layer_{i}"
            x, new_cache[name] = getattr(self, name)(
                x, rope_cs, causal, kv_mask, cache[name], None, layer_view(i)
            )
        if device_index:
            start.add_(s)
        return self.final_norm(x), new_cache


class LlamaForCausalLM(nn.Module):
    """Decoder + f32 ``lm_head``. ``forward(..., decode=True, cache=None)``
    returns ``(logits [B, S, V] f32, cache)``; a ``cache`` of None starts
    from a zeroed one (the flax decode idiom); with ``decode=False`` it
    returns ``(logits, None)``. ``device="meta"`` builds a weight-free
    skeleton whose parameters come from ``bind_params``."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, device)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 device=device, dtype=torch.float32)
        self.requires_grad_(False)
        # The f32 lm_head product stays f32 on the card (flax
        # Dense(dtype=float32) is a full-precision dot).
        torch.backends.cuda.matmul.allow_tf32 = False
        self._bound_params = None

    def forward(self, input_ids, attention_mask=None, decode=False,
                positions=None, cache=None, paged=None, adapters=None):
        x, model_cache = self.model(
            input_ids, attention_mask, decode, positions,
            None if cache is None else cache["model"], paged, adapters,
        )
        logits = F.linear(x.float(), self.lm_head.weight)
        return logits, None if model_cache is None else {"model": model_cache}

    def tpudl_path(self, name: str) -> str:
        return tpudl_path(name)


def bind_params(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Make the tensors of ``params`` (a state_dict) the module's
    parameters, without copying — the PyTorch side of flax's
    ``model.apply({"params": params}, ...)``. A dict is bound once; the
    same dict object afterwards costs nothing, so the serving loop pays
    nothing per step. Pass a new dict to rebind."""
    if model._bound_params is not params:
        own = model.state_dict()
        wrong = [k for k, v in params.items()
                 if k in own and v.dtype != own[k].dtype]
        if wrong:
            raise ValueError(
                f"params dtypes do not match the config's (e.g. {wrong[0]}: "
                f"{params[wrong[0]].dtype}, expected {own[wrong[0]].dtype})"
            )
        model.load_state_dict(params, strict=True, assign=True)
        model._bound_params = params


def params_device(params: Dict[str, torch.Tensor]) -> torch.device:
    return params["model.embed_tokens.weight"].device


def _init_(name: str, t: torch.Tensor, generator, lora_rank: int) -> None:
    """Draw one parameter in place as tpudl's ``model.init`` does:
    normal(0.02) kernels and embedding, unit norm scales, zero biases,
    ``lora_a`` normal(1/r) and ``lora_b`` zeros."""
    if name.endswith(".scale"):
        t.fill_(1.0)
    elif name.endswith((".bias", ".lora_b")):
        t.zero_()
    elif name.endswith(".lora_a"):
        t.normal_(0.0, 1.0 / lora_rank, generator=generator)
    else:
        t.normal_(0.0, 0.02, generator=generator)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A fresh parameter state_dict of ``LlamaForCausalLM(cfg)`` drawn
    like tpudl's ``model.init`` (see ``_init_``). Each tensor is made on
    ``device`` in its stored dtype (``generator`` must live on the same
    device)."""
    skeleton = LlamaForCausalLM(cfg, device="meta")
    params = {}
    for name, p in skeleton.state_dict().items():
        t = torch.empty(p.shape, dtype=p.dtype, device=device)
        _init_(name, t, generator, cfg.lora_rank)
        params[name] = t
    return params


class LlamaForSequenceClassification(nn.Module):
    """The ``configs[4]`` fine-tune model: classify from the last non-pad
    token's final hidden state (causal-LM pooling) with an f32
    ``classifier`` (weight and bias). ``forward(input_ids,
    attention_mask=None, train=False, generator=None)`` returns f32
    logits ``[B, num_labels]`` (Llama has no dropout, so ``train`` and
    ``generator`` change nothing). With adapters (``lora_rank`` > 0) the
    base is built frozen in ``cfg.dtype`` and the adapters and the
    classifier train; with ``lora_rank=0`` every parameter trains
    against f32 masters, as tpudl's. Built on ``device`` with weights
    drawn from torch's default generator; ``init_weights`` (which
    ``create_train_state`` calls) redraws them from a seeded one."""

    def __init__(self, cfg: LlamaConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        full = cfg.lora_rank == 0
        self.model = LlamaModel(cfg, device, masters=full)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels,
                                    device=device, dtype=torch.float32)
        for name, p in self.named_parameters():
            p.requires_grad_(full or is_lora_param(name)
                             or name.startswith("classifier."))
        # The f32 classifier product stays f32 on the card (flax
        # Dense(dtype=float32) is a full-precision dot).
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.device(device).type != "meta":
            self.init_weights(None)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """Redraw every parameter in place (see ``_init_``); ``generator``
        lives on the model's device (None: torch's default)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                _init_(name, p, generator, self.cfg.lora_rank)

    def forward(self, input_ids, attention_mask=None, train=False,
                generator=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x, _ = self.model(input_ids, attention_mask)
        last = (attention_mask.sum(-1) - 1).clamp_min(0).long()
        pooled = x[torch.arange(x.shape[0], device=x.device), last]
        # f32 whatever a precision policy hands the kernel (flax promotes
        # it back to the Dense's f32).
        return F.linear(pooled.float(), self.classifier.weight.float(),
                        self.classifier.bias)

    def tpudl_path(self, name: str) -> str:
        return tpudl_path(name)


def tpudl_path(name: str) -> str:
    """A state_dict name's tpudl tree path, the inverse of
    ``params_from_tpudl``: ``model.layer_0.attention.q_proj.weight`` ->
    ``model/layer_0/attention/q_proj/kernel``, the embedding table's
    ``weight`` -> ``embedding``."""
    module, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "embedding" if module.endswith("embed_tokens") else "kernel"
    elif leaf in ("qvalues", "qscale"):
        leaf = f"kernel.{leaf}"
    return f"{module}.{leaf}".replace(".", "/")


_PROJECTIONS = ("attention.q_proj", "attention.k_proj", "attention.v_proj",
                "attention.o_proj", "gate_proj", "up_proj", "down_proj")
_MOE_LEAVES = ("moe.router.weight", "moe.wi", "moe.wg", "moe.wo")


def param_names(num_layers: int, lora: bool, head: str, moe: bool = False,
                quantized=()):
    """The state_dict keys of a Llama model with ``num_layers`` layers,
    adapters or not, and ``head`` "lm_head" (LlamaForCausalLM) or
    "classifier" (LlamaForSequenceClassification). ``moe``: every block's
    MLP is an MoEMlp. ``quantized``: the modules whose weight is a
    quantized pair (``X.qvalues``, ``X.qscale`` in place of ``X.weight``)."""
    names = {"model.embed_tokens.weight", "model.final_norm.scale"}
    names |= ({"lm_head.weight"} if head == "lm_head"
              else {"classifier.weight", "classifier.bias"})
    leaves = ["weight"] + (["lora_a", "lora_b"] if lora else [])
    projections = _PROJECTIONS[:4] if moe else _PROJECTIONS
    for i in range(num_layers):
        layer = f"model.layer_{i}"
        names |= {f"{layer}.input_norm.scale",
                  f"{layer}.post_attention_norm.scale"}
        names |= {f"{layer}.{proj}.{leaf}" for proj in projections
                  for leaf in leaves}
        if moe:
            names |= {f"{layer}.{leaf}" for leaf in _MOE_LEAVES}
    for site in quantized:
        if f"{site}.weight" in names:
            names = (names - {f"{site}.weight"}) | {f"{site}.qvalues",
                                                   f"{site}.qscale"}
    return names


#: Leaves kept in f32 whatever the compute dtype.
_F32_LEAVES = ("scale", "lora_a", "lora_b", "qscale")
#: Modules whose weight stays f32 (tpudl's f32 Dense heads and router).
_F32_MODULES = ("lm_head", "classifier")


def params_from_tpudl(tree, dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Convert a tpudl ``LlamaForCausalLM`` or
    ``LlamaForSequenceClassification`` params tree (nested dicts of numpy
    arrays, as ``model.init(...)["params"]`` holds them; LoRA adapters,
    MoE blocks, quantized projections or not) to this module's
    state_dict.

    Each weight is stored in the dtype the JAX model computes with it:
    the projections, the experts and the embedding in ``dtype`` (the
    config's — flax ``Dense(dtype=bf16)`` casts its f32 kernel at use, so
    storing bf16 gives the same numbers at half the bytes), the RMSNorm
    scales, the ``lm_head``, the classifier, the MoE router and the
    adapters in f32. Dense kernels ``[in, out]`` become Linear weights
    ``[out, in]``; ``lora_a`` ``[in, r]``, ``lora_b`` ``[r, out]`` and the
    expert weights ``moe/wi``, ``moe/wg`` ``[E, M, H]`` and ``moe/wo``
    ``[E, H, M]`` keep tpudl's orientation. A quantized kernel
    (``kernel/qvalues``, ``kernel/qscale``) becomes ``X.qvalues``
    (transposed, in its own int8 / float8_e4m3fn dtype) and ``X.qscale``
    (f32). Raises on a leaf this module has no place for and on one the
    model needs that the tree lacks."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            module, leaf = ".".join(path), key
            if leaf in ("qvalues", "qscale") and path and path[-1] == "kernel":
                module = ".".join(path[:-1])
                if leaf == "qvalues":
                    out[f"{module}.qvalues"] = quantized_tensor(
                        value).t().contiguous().to(device)
                else:
                    out[f"{module}.qscale"] = torch.tensor(
                        np.asarray(value, np.float32), device=device)
                continue
            arr = np.asarray(value, dtype=np.float32)
            if leaf == "kernel":
                arr, name = arr.T, f"{module}.weight"
            elif leaf == "embedding":
                name = f"{module}.weight"
            elif leaf in ("scale", "bias", "lora_a", "lora_b") or (
                    leaf in ("wi", "wg", "wo") and path[-1:] == ["moe"]):
                name = f"{module}.{leaf}"
            else:
                raise ValueError(
                    f"tpudl leaf {'/'.join(path + [key])} has no "
                    f"counterpart in tpudl_torch"
                )
            keep_f32 = (leaf in _F32_LEAVES or module in _F32_MODULES
                        or module.endswith("moe.router"))
            out[name] = torch.tensor(np.ascontiguousarray(arr)).to(
                device=device, dtype=torch.float32 if keep_f32 else dtype
            )

    walk(tree, [])
    layers = [int(k.split(".")[1].removeprefix("layer_")) for k in out
              if k.startswith("model.layer_")]
    want = param_names(
        max(layers) + 1 if layers else 0,
        any(is_lora_param(k) for k in out),
        "classifier" if any(k.startswith("classifier.") for k in out)
        else "lm_head",
        moe=any(".moe." in k for k in out),
        quantized=[k[: -len(".qvalues")] for k in out
                   if k.endswith(".qvalues")])
    unmapped = sorted(set(out) - want)
    missing = sorted(want - set(out))
    if unmapped:
        raise ValueError(f"tpudl leaves with no counterpart in tpudl_torch: "
                         f"{unmapped}")
    if missing:
        raise ValueError(f"tpudl tree lacks parameters: {missing}")
    return out
