"""Post-training weight quantization of a trained state_dict: the port's
counterpart of tpudl.quant.quantize.

Rule-driven, as tpudl's: a rule list of ``(path_regex,
weight_dtype_or_None)`` pairs is matched against each leaf's tpudl tree
path (``model/layer_0/attention/q_proj/kernel``; the port's names map to
it through the model's ``tpudl_path``, so the same regex selects the
same leaf in both packages), first match wins; ``None`` keeps full
precision, ``"int8"`` / ``"fp8_e4m3"`` quantize. The default rule sets
quantize exactly the decode-bandwidth-dominant projections (attention
and MLP) and keep norms, embeddings and heads full precision.

Quantization is symmetric per OUTPUT channel. tpudl's kernel is ``[in,
out]`` and reduces over every axis but the last; the port's weight is
the torch Linear layout ``[out, in]`` (tpudl's kernel transposed), so
the scale reduces over every axis but the FIRST. ``qvalues`` are
tpudl's transposed, bit for bit, and ``qscale`` is tpudl's.

Storage: a quantized leaf is the pair ``{"qvalues", "qscale"}``. In a
state_dict the pair replaces the projection's ``X.weight`` by two
entries, ``X.qvalues`` (int8 or float8_e4m3fn ``[out, in]``) and
``X.qscale`` (f32 ``[out]``): the two buffers of
tpudl_torch.quant.dense.QuantDense, whose ``tpudl_path`` is tpudl's
``X/kernel/qvalues`` and ``X/kernel/qscale``. So the checkpoint store
(tpudl_torch.ft.store, tpudl's on-disk format) round-trips a quantized
state_dict with tpudl's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tpudl_torch import rules as rules_engine

#: Supported weight storage dtypes (tpudl's names).
QUANT_DTYPES = ("int8", "fp8_e4m3")

#: Symmetric int8 range (the paged KV quantizer shares it).
INT8_MAX = 127.0
#: Largest finite e4m3 magnitude.
E4M3_MAX = 448.0
#: Scale floor: an all-zero channel dequantizes to zeros, not NaN.
SCALE_EPS = 1e-12

Rule = Tuple[str, Optional[str]]
Rules = Sequence[Rule]

#: The Llama leaves that quantize: the seven per-block projections
#: (tpudl's patterns, verbatim).
LLAMA_QUANT_PATTERNS = (
    r"(q|k|v|o)_proj/kernel$",
    r"(gate|up|down)_proj/kernel$",
)

#: The BERT leaves that quantize: encoder attention and MLP projections.
BERT_QUANT_PATTERNS = (
    r"attention/(query|key|value|out)/kernel$",
    r"encoder/layer_\d+/(intermediate|output)/kernel$",
)

_PAIR = ("qvalues", "qscale")


def validate_weight_dtype(weight_dtype: str) -> str:
    if weight_dtype not in QUANT_DTYPES:
        raise ValueError(
            f"weight_dtype must be one of {QUANT_DTYPES}, got "
            f"{weight_dtype!r}"
        )
    return weight_dtype


def is_quantized(leaf: Any) -> bool:
    """True for the ``{"qvalues", "qscale"}`` quantized-leaf dict."""
    return isinstance(leaf, dict) and set(leaf) == set(_PAIR)


def quantize_leaf(w: torch.Tensor, weight_dtype: str) -> dict:
    """Symmetric per-output-channel quantization of one weight ``[out,
    ...]``: ``{"qvalues": [out, ...] in the storage dtype, "qscale": f32
    [out]}`` with ``scale = max(max|w_channel| / range, SCALE_EPS)``.
    int8: f32 division, round half to even, clip to +-127; e4m3: a cast
    of ``w / scale`` (no value exceeds 448 by construction)."""
    validate_weight_dtype(weight_dtype)
    if w.dim() < 2:
        raise ValueError(
            f"per-output-channel quantization needs a >=2-D weight, got "
            f"shape {tuple(w.shape)} — rules must leave scalars/vectors "
            f"(biases, norm scales) full precision"
        )
    wf = w.detach().float()
    absmax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    top = INT8_MAX if weight_dtype == "int8" else E4M3_MAX
    scale = (absmax / top).clamp_min(SCALE_EPS)
    scaled = wf / scale.view(-1, *([1] * (wf.dim() - 1)))
    if weight_dtype == "int8":
        q = scaled.round().clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = scaled.to(torch.float8_e4m3fn)
    return {"qvalues": q, "qscale": scale}


def dequantize_leaf(leaf: dict, dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Materialize a quantized leaf at full precision (the composite
    reference path; the fused product never calls this)."""
    q, s = leaf["qvalues"], leaf["qscale"]
    return (q.float() * s.view(-1, *([1] * (q.dim() - 1)))).to(dtype)


def default_tpudl_path(name: str) -> str:
    """A state_dict name's tpudl tree path for models without their own
    ``tpudl_path``: ``X.weight`` -> ``X/kernel`` (``X/embedding`` for an
    embedding table), ``X.qvalues`` -> ``X/kernel/qvalues``."""
    module, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = ("embedding" if module.endswith(("embed_tokens", "_embeddings"))
                else "kernel")
    elif leaf in _PAIR:
        leaf = f"kernel.{leaf}"
    return f"{module}.{leaf}".replace(".", "/")


def logical_leaves(params: Dict[str, Any]) -> Iterator[Tuple[str, Any]]:
    """``(name, leaf)`` of a state_dict with each quantized pair as ONE
    leaf: ``X.qvalues`` and ``X.qscale`` come back as ``("X.weight",
    {"qvalues": ..., "qscale": ...})``, where the pair's first entry
    stood."""
    seen = set()
    for name, leaf in params.items():
        module, last = name.rsplit(".", 1) if "." in name else ("", name)
        if last not in _PAIR:
            yield name, leaf
            continue
        if module in seen:
            continue
        seen.add(module)
        missing = [p for p in _PAIR if f"{module}.{p}" not in params]
        if missing:
            raise ValueError(f"{module}: quantized pair lacks {missing}")
        yield f"{module}.weight", {p: params[f"{module}.{p}"] for p in _PAIR}


def _put(out: Dict[str, Any], name: str, leaf: Any) -> None:
    """Store one logical leaf back in state_dict form."""
    if is_quantized(leaf):
        module = name.rsplit(".", 1)[0]
        for p in _PAIR:
            out[f"{module}.{p}"] = leaf[p]
    else:
        out[name] = leaf


def _dtype_for(name: str, leaf: Any, rules: Rules,
               path: Callable[[str], str]) -> Optional[str]:
    """First-match rule lookup for one logical leaf. Already-quantized
    pairs and leaves with ndim < 2 never quantize; a >=2-D leaf no rule
    covers raises (an uncovered parameter is a rule-set bug)."""
    if is_quantized(leaf) or leaf.dim() < 2:
        return None
    p = path(name)
    dtype = rules_engine.first_match(rules, p)
    if dtype is rules_engine.NO_MATCH:
        raise ValueError(
            f"no quantization rule matches parameter {p!r} — add an "
            f"explicit (pattern, None) keep rule or a catch-all"
        )
    return dtype


def match_quant_rules(rules: Rules, params: Dict[str, Any],
                      path: Callable[[str], str] = default_tpudl_path
                      ) -> Dict[str, Optional[str]]:
    """Logical leaf name -> weight dtype or None, first match over the
    leaf's tpudl path (a quantized pair is one leaf, named by its
    ``X.weight``)."""
    return {name: _dtype_for(name, leaf, rules, path)
            for name, leaf in logical_leaves(params)}


def quantize_tree(params: Dict[str, Any], rules: Rules,
                  path: Callable[[str], str] = default_tpudl_path
                  ) -> Dict[str, Any]:
    """Quantize a state_dict by rules: each matched ``X.weight`` becomes
    ``X.qvalues`` and ``X.qscale`` in its place; every other leaf, and
    every already-quantized pair, is the same tensor (idempotent)."""
    out: Dict[str, Any] = {}
    for name, leaf in logical_leaves(params):
        dtype = _dtype_for(name, leaf, rules, path)
        _put(out, name, leaf if dtype is None else quantize_leaf(leaf, dtype))
    return out


def dequantize_tree(params: Dict[str, Any],
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Inverse transform (to quantized precision, not the original
    values): every pair materialized at ``dtype`` as ``X.weight``."""
    out: Dict[str, Any] = {}
    for name, leaf in logical_leaves(params):
        out[name] = dequantize_leaf(leaf, dtype) if is_quantized(leaf) else leaf
    return out


def default_quant_rules(model_or_cfg: Any, weight_dtype: str) -> Rules:
    """The model family's rule set at ``weight_dtype``: quantize the
    attention/MLP projections, keep everything else (final ``(".*",
    None)``). Dispatches on the config: Llama (``rope_theta``) or BERT
    (``type_vocab_size``)."""
    validate_weight_dtype(weight_dtype)
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if hasattr(cfg, "rope_theta"):
        patterns = LLAMA_QUANT_PATTERNS
    elif hasattr(cfg, "type_vocab_size"):
        patterns = BERT_QUANT_PATTERNS
    else:
        raise ValueError(
            f"no default quantization rules for {type(cfg).__name__}; "
            f"pass explicit rules to quantize_tree"
        )
    return tuple((p, weight_dtype) for p in patterns) + ((r".*", None),)


def quantize_model(model: Any, params: Dict[str, Any], weight_dtype: str,
                   rules: Optional[Rules] = None) -> Tuple[Any, Dict[str, Any]]:
    """The one-call serving entry: ``(model, params) -> (model with
    ``cfg.weight_dtype`` set, quantized state_dict)``. The model comes
    back as it was when its config already names ``weight_dtype``, else
    as a weight-free skeleton of the same class (built on ``meta``) whose
    projections are QuantDense: its weights are the state_dict it is
    bound to (tpudl_torch.models.llama.bind_params, or
    ``load_state_dict(..., assign=True)``). This is what
    ``ServeSession.from_model(weight_dtype=...)`` runs."""
    validate_weight_dtype(weight_dtype)
    cfg = model.cfg
    if not hasattr(cfg, "weight_dtype"):
        raise ValueError(
            f"{type(cfg).__name__} has no weight_dtype seam — only the "
            f"Llama/BERT families serve quantized"
        )
    if rules is None:
        rules = default_quant_rules(cfg, weight_dtype)
    if cfg.weight_dtype != weight_dtype:
        model = type(model)(dataclasses.replace(cfg, weight_dtype=weight_dtype),
                            device="meta")
    return model, quantize_tree(params, rules, model.tpudl_path)


def weight_bytes_report(params: Dict[str, Any]) -> dict:
    """Bytes accounting for the serving bytes-moved model: total resident
    parameter bytes, the quantized layers' stored bytes against their f32
    equivalent (``quant_ratio``), and leaf counts (tpudl's keys)."""
    total = quant_bytes = quant_f32 = n_quant = n_leaves = 0
    for _, leaf in logical_leaves(params):
        n_leaves += 1
        if is_quantized(leaf):
            n_quant += 1
            stored = sum(t.numel() * t.element_size() for t in leaf.values())
            quant_bytes += stored
            quant_f32 += leaf["qvalues"].numel() * 4
            total += stored
        else:
            total += leaf.numel() * leaf.element_size()
    return {
        "total_bytes": total,
        "quantized_layer_bytes": quant_bytes,
        "quantized_layer_f32_bytes": quant_f32,
        "quant_ratio": round(quant_f32 / quant_bytes, 3) if quant_bytes else None,
        "num_quantized_leaves": n_quant,
        "num_leaves": n_leaves,
    }


def quantized_tensor(value) -> torch.Tensor:
    """A tpudl ``qvalues`` array (numpy int8, or ml_dtypes'
    float8_e4m3fn) as a torch tensor of the same dtype and bits."""
    arr = np.array(value, copy=True, order="C")
    if arr.dtype == np.int8:
        return torch.from_numpy(arr)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    raise ValueError(f"quantized leaf of dtype {arr.dtype}: expected int8 "
                     f"or float8_e4m3fn")
