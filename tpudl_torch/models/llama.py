"""Llama-family decoder (RoPE + RMSNorm + SwiGLU + GQA) in PyTorch: the
dense decode path.

The port's counterpart of tpudl.models.llama, cut to what serving runs:
tpudl's prefill and decode both apply the model with ``decode=True``
(tpudl.models.generate.prefill_fn), so this module ports the dense
KV-cache branch of ``LlamaAttention``, the dense-MLP ``LlamaBlock``,
``LlamaModel`` and ``LlamaForCausalLM``. The non-decode forward (flash
attention), MoE, LoRA, quantized weights and fp8 training wait for
later slices and raise ``NotImplementedError``.

Numerics follow the JAX model: projections and the embedding compute in
``cfg.dtype``, RMSNorm statistics in f32, RoPE angles in f32, attention
logits and softmax in f32, and the ``lm_head`` in full f32 (TF32 off).
With ``cfg.fused_ops`` (default True here) the norms and the SwiGLU go
through the Hopper kernels of tpudl_torch.ops on CUDA tensors.

Parameters mirror tpudl's tree: ``model.layer_{i}.attention.q_proj.weight``
holds tpudl's ``model/layer_{i}/attention/q_proj/kernel`` transposed
(``[out, in]``, the torch Linear layout); ``params_from_tpudl`` converts a
tpudl params tree, ``init_params`` draws a fresh one from a
``torch.Generator`` the way ``model.init`` does.

The KV cache is an explicit dict in the layout of tpudl's flax ``cache``
collection: ``cache["model"]["layer_{i}"]["attention"]`` holds ``k``,
``v`` ([B, max_seq_len, Hkv, D]), ``valid`` ([B, max_seq_len] bool) and
``index`` (the shared write position, a host int). Unlike JAX, the
forward writes ``k``/``v``/``valid`` IN PLACE (no cache-sized copy per
step) and returns a new dict carrying the advanced ``index``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudl_torch.ops.attention import MASK_VALUE
from tpudl_torch.ops.mlp_fused import swiglu
from tpudl_torch.ops.norms import fused_ops_impl, rms_norm


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
    dtype: torch.dtype = torch.bfloat16
    # Kernel tier: False = plain PyTorch norms/SwiGLU everywhere; True
    # (the default here) = the Hopper kernels on CUDA tensors, the plain
    # versions on CPU tensors; "force" = the kernels or an error.
    fused_ops: Any = True
    # Tiers of the JAX model that are not ported yet; any other value
    # raises NotImplementedError when the model is built.
    lora_rank: int = 0
    weight_dtype: Optional[str] = None
    fp8_train: Any = False
    moe_experts: int = 0

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

_NOT_PORTED = (
    ("lora_rank", 0, "LoRA adapters"),
    ("moe_experts", 0, "the MoE MLP"),
    ("weight_dtype", None, "quantized serving weights"),
    ("fp8_train", False, "fp8 training matmuls"),
)


def _check_ported(cfg: LlamaConfig) -> None:
    for field, off, what in _NOT_PORTED:
        if getattr(cfg, field) != off:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: {what} are not ported to "
                f"tpudl_torch yet (ROADMAP queue A)"
            )


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


def _linear(cfg, d_in, d_out, device):
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=cfg.dtype)


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
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.q_proj = _linear(cfg, cfg.hidden_size, cfg.num_heads * hd, device)
        self.k_proj = _linear(cfg, cfg.hidden_size, cfg.num_kv_heads * hd, device)
        self.v_proj = _linear(cfg, cfg.hidden_size, cfg.num_kv_heads * hd, device)
        self.o_proj = _linear(cfg, cfg.num_heads * hd, cfg.hidden_size, device)

    def forward(self, hidden, rope_cs, causal, kv_mask, cache):
        """Dense decode branch: write this chunk's k/v/validity at the
        cache's write index, attend to slots that are causally prior in
        WRITE order and valid. ``causal`` is the [1, 1, S, T] slot-order
        triangle for this chunk; ``cache`` is this layer's dict."""
        cfg = self.cfg
        b, s, _ = hidden.shape
        hd = cfg.head_dim
        q = self.q_proj(hidden).view(b, s, cfg.num_heads, hd)
        k = self.k_proj(hidden).view(b, s, cfg.num_kv_heads, hd)
        v = self.v_proj(hidden).view(b, s, cfg.num_kv_heads, hd)
        q = apply_rope(q, *rope_cs)
        k = apply_rope(k, *rope_cs)

        ck, cv, cvalid = cache["k"], cache["v"], cache["valid"]
        start = cache["index"]
        if start + s > ck.shape[1]:
            raise ValueError(
                f"cache write [{start}, {start + s}) runs past max_seq_len "
                f"{ck.shape[1]} (tpudl's dynamic_update_slice would clamp "
                f"it onto the last slots and corrupt the cache)"
            )
        ck[:, start:start + s] = k
        cv[:, start:start + s] = v
        cvalid[:, start:start + s] = True if kv_mask is None else kv_mask.bool()
        mask = causal & cvalid[:, None, None, :]
        # Grouped-query attention against the UNEXPANDED cache.
        ctx = _gqa_decode_attention(q, ck, cv, mask)
        out = self.o_proj(ctx.reshape(b, s, cfg.num_heads * hd))
        return out, {"k": ck, "v": cv, "valid": cvalid, "index": start + s}


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        _check_ported(cfg)
        self.impl = fused_ops_impl(cfg.fused_ops)
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, self.impl, device)
        self.attention = LlamaAttention(cfg, device)
        self.post_attention_norm = RMSNorm(h, cfg.rms_norm_eps, self.impl, device)
        self.gate_proj = _linear(cfg, h, f, device)
        self.up_proj = _linear(cfg, h, f, device)
        self.down_proj = _linear(cfg, f, h, device)

    def forward(self, hidden, rope_cs, causal, kv_mask, cache):
        attn, attn_cache = self.attention(
            self.input_norm(hidden), rope_cs, causal, kv_mask,
            cache["attention"],
        )
        # The attention residual add rides inside the post-attention norm
        # kernel; the summed value comes back as the carried residual.
        x, hidden = self.post_attention_norm(attn, residual=hidden)
        act = swiglu(self.gate_proj(x), self.up_proj(x), impl=self.impl)
        return hidden + self.down_proj(act), {"attention": attn_cache}


class LlamaModel(nn.Module):
    """Decoder stack: embeddings + N blocks + final RMSNorm."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(
            cfg.vocab_size, cfg.hidden_size, device=device, dtype=cfg.dtype
        )
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg, device))
        self.final_norm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, fused_ops_impl(cfg.fused_ops),
            device,
        )

    def forward(self, input_ids, attention_mask=None, decode=False,
                positions=None, cache=None):
        cfg = self.cfg
        if not decode:
            raise NotImplementedError(
                "the non-decode forward (training / classification, with "
                "flash attention) is not ported yet; serving runs "
                "decode=True for prefill and decode alike"
            )
        kv_mask = attention_mask
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if positions is None:
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        if cache is None:
            cache = init_cache(cfg, input_ids.shape[0],
                               self.embed_tokens.weight.device)["model"]
        x = self.embed_tokens(input_ids.long()).to(cfg.dtype)
        s = input_ids.shape[1]
        start = cache["layer_0"]["attention"]["index"]
        if any(cache[f"layer_{i}"]["attention"]["index"] != start
               for i in range(cfg.num_layers)):
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
                x, rope_cs, causal, kv_mask, cache[name]
            )
        return self.final_norm(x), new_cache


class LlamaForCausalLM(nn.Module):
    """Decoder + f32 ``lm_head``. ``forward(..., decode=True, cache=None)``
    returns ``(logits [B, S, V] f32, cache)``; a ``cache`` of None starts
    from a zeroed one (the flax decode idiom). ``device="meta"`` builds a
    weight-free skeleton whose parameters come from ``bind_params``."""

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
                positions=None, cache=None):
        x, model_cache = self.model(
            input_ids, attention_mask, decode, positions,
            None if cache is None else cache["model"],
        )
        logits = F.linear(x.float(), self.lm_head.weight)
        return logits, {"model": model_cache}


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


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A fresh parameter state_dict drawn like tpudl's ``model.init``:
    normal(0.02) projections, embedding and lm_head; ones for the norm
    scales. Each tensor is made on ``device`` in its compute dtype
    (``generator`` must live on the same device)."""
    skeleton = LlamaForCausalLM(cfg, device="meta")
    params = {}
    for name, p in skeleton.state_dict().items():
        t = torch.empty(p.shape, dtype=p.dtype, device=device)
        if name.endswith(".scale"):
            t.fill_(1.0)
        else:
            t.normal_(0.0, 0.02, generator=generator)
        params[name] = t
    return params


def params_from_tpudl(tree, dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Convert a tpudl ``LlamaForCausalLM`` params tree (nested dicts of
    numpy arrays, as ``model.init(...)["params"]`` holds them) to this
    module's state_dict.

    Each weight is stored in the dtype the JAX model computes with it:
    the projections and the embedding in ``dtype`` (the config's — flax
    ``Dense(dtype=bf16)`` casts its f32 kernel at use, so storing bf16
    gives the same numbers at half the bytes), the RMSNorm scales and
    the ``lm_head`` in f32. Dense kernels ``[in, out]`` become Linear
    weights ``[out, in]``. Raises on a leaf this module has no place for
    (LoRA, MoE, quantized kernels)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            arr = np.asarray(value, dtype=np.float32)
            module, leaf = ".".join(path), key
            if leaf == "kernel":
                arr, name = arr.T, f"{module}.weight"
            elif leaf == "embedding":
                name = f"{module}.weight"
            elif leaf == "scale":
                name = f"{module}.scale"
            else:
                raise ValueError(
                    f"tpudl leaf {'/'.join(path + [key])} has no "
                    f"counterpart in tpudl_torch (LoRA/MoE/quantized "
                    f"trees are not ported yet)"
                )
            keep_f32 = leaf == "scale" or module == "lm_head"
            out[name] = torch.tensor(np.ascontiguousarray(arr)).to(
                device=device, dtype=torch.float32 if keep_f32 else dtype
            )

    walk(tree, [])
    return out
