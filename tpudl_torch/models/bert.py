"""BERT in PyTorch: encoder, pooler and classification head.

The port's counterpart of tpudl.models.bert (the BASELINE.json
``configs[1]`` BERT-base SST-2 fine-tune). Numerics follow the JAX
model:

- parameters are f32 masters; every projection casts its weight and bias
  to ``cfg.dtype`` at use, as flax ``nn.Dense(dtype=bf16)`` does;
- the embedding sum is f32 (flax ``nn.Embed`` with no dtype returns its
  f32 table), its LayerNorm is f32, and its output is cast to
  ``cfg.dtype`` after dropout;
- the encoder's LayerNorms take f32 statistics and write ``cfg.dtype``;
  attention runs through tpudl_torch.ops.attention.attend (bf16
  products, f32 softmax): ``cfg.attention_impl="reference"`` is the
  batched-product composite, "fused" the softmax+dropout kernels around
  plain products (12 calls each way per BERT-base step at S <= 256),
  whose attention dropout draws two seed words per call from the
  generator instead of uint8 bits (tpudl_torch.ops.keep_mask);
- the classifier computes in f32 (``nn.Dense(dtype=float32)``).

``cfg.fused_ops`` picks the tier, as in tpudl: False = the composite
path (LayerNorm of ``hidden + out``, Dense with bias, exact GeLU); True =
the fused path — the residual add inside the LayerNorm (tpudl_torch.ops
.norms.layer_norm, which skips the unused sum write) and the
intermediate bias inside the GeLU (tpudl_torch.ops.mlp_fused.bias_gelu),
whose Hopper kernels run on CUDA tensors and whose plain versions run on
CPU tensors; "force" = the kernels or an error. Per forward the fused
path runs 25 LayerNorms and 12 bias+GeLUs at BERT-base.

Dropout draws from an explicit ``torch.Generator`` passed to
``forward`` (the flax "dropout" rng); the calls draw in a fixed order,
so two forwards with generators seeded alike draw the same masks on
either tier and in either dtype.

Parameters mirror tpudl's tree: ``bert.encoder.layer_0.attention.query
.weight`` holds tpudl's ``bert/encoder/layer_0/attention/query/kernel``
transposed (``[out, in]``); ``params_from_tpudl`` converts a tpudl tree.

``cfg.remat`` is tpudl's: "layer" (or True) recomputes each encoder layer
in the backward, "attention" each self-attention block, with
``remat_policy`` None (save nothing) or "dots_saveable" (keep the matrix
products, "layer" only); tpudl_torch.models.remat draws the recompute's
dropout bits from the step generator's recorded state, so the gradients
are bitwise those without remat. ``weight_dtype`` ("int8", "fp8_e4m3")
makes the sites tpudl's ``BERT_QUANT_PATTERNS`` names (the four attention
projections, the intermediate and the output) tpudl_torch.quant.dense
.QuantDense: bound to a state_dict quantize_model quantized, their
product is the hand-written weight-only kernel, the bias added after it
(the fused intermediate's bias inside the bias+GeLU kernel, as tpudl's
``FusedBiasGeluDense``); bound to a full-precision one, ``Dense``'s exact
math.

``cfg.fp8_train`` is tpudl's fp8 training tier: the encoder's attention
and MLP projections that tpudl's ``_dense(quantize=True)`` marks become
tpudl_torch.ops.fp8_dot.Fp8Dense (the same f32 master ``weight`` and
``bias``; e4m3 forward and e5m2 gradient products with delayed scaling,
their amax rings carried by a train state built with the "fp8" policy).
With ``fused_ops`` the intermediate projection stays a plain product in
``cfg.dtype`` (tpudl's ``FusedBiasGeluDense``), so the fused model has 5
fp8 sites a layer and the composite model 6; the pooler and the
classifier stay full precision. True or "auto" picks the fp8 product's
implementation by device, "reference" the plain one, "force" (or
"fused") ``torch._scaled_mm`` or an error (``fp8_train_impl``). It excludes ``weight_dtype``.
``tpudl_path`` maps a parameter name to its tpudl tree path (the inverse
of ``params_from_tpudl``), which the precision rules match.
"""

from __future__ import annotations

import dataclasses
import re
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpudl_torch.models.remat import check_policy, checkpointed
from tpudl_torch.ops.attention import attend, padding_mask
from tpudl_torch.ops.dropout import Dropout
from tpudl_torch.ops.fp8_dot import Fp8Dense, fp8_train_impl
from tpudl_torch.ops.mlp_fused import bias_gelu
from tpudl_torch.ops.norms import fused_ops_impl, layer_norm
from tpudl_torch.quant.dense import QuantDense
from tpudl_torch.quant.quantize import quantized_tensor, validate_weight_dtype


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # True = bernoulli masks at the nominal rate; False (default) = uint8
    # bits, rate quantized to 1/256 (tpudl_torch.ops.dropout).
    dropout_exact: bool = False
    num_labels: int = 2
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "reference"
    #: Rematerialization: False / "none", True / "layer", "attention".
    remat: Any = False
    #: "layer" remat's policy: None or "dots_saveable".
    remat_policy: Optional[str] = None
    #: Fused-epilogue tier: False = composite, True = the Hopper kernels on
    #: CUDA tensors and the plain versions on CPU tensors, "force" = the
    #: kernels or an error.
    fused_ops: Any = False
    # The quantized weight tier is not ported yet; any other value
    # raises NotImplementedError when the model is built.
    weight_dtype: Optional[str] = None
    #: fp8 training products at the encoder's projections (module
    #: docstring): False, True / "auto", "reference", "force" / "fused".
    fp8_train: Any = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


BERT_TINY = partial(BertConfig, hidden_size=128, num_layers=2, num_heads=2,
                    intermediate_size=512)
BERT_BASE = BertConfig
BERT_LARGE = partial(BertConfig, hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096)

_REMAT = (False, "none", True, "layer", "attention")

_FP8_IMPLS = (False, True, "auto", "reference", "force", "fused")


def _check_ported(cfg: BertConfig) -> None:
    if cfg.remat not in _REMAT:
        raise ValueError(f"remat must be one of {_REMAT}, got {cfg.remat!r}")
    check_policy(cfg.remat_policy)
    if cfg.fp8_train not in _FP8_IMPLS:
        raise ValueError(f"fp8_train must be one of {_FP8_IMPLS}, got "
                         f"{cfg.fp8_train!r}")
    if cfg.fp8_train and cfg.weight_dtype is not None:
        raise ValueError(
            "fp8_train (training-time fp8 matmuls) and weight_dtype "
            "(serving quantization of a frozen tree) are mutually "
            "exclusive — pick one")
    if cfg.weight_dtype is not None:
        validate_weight_dtype(cfg.weight_dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype, use_bias=use_bias)``: an f32
    master ``weight`` ``[out, in]`` and ``bias``, both cast to ``dtype``
    at use, the input too. ``forward(x, add_bias=False)`` returns the
    product without the bias (the fused bias+GeLU epilogue adds it)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None,
                 use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(d_out, d_in, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            d_out, dtype=torch.float32, device=device)) if use_bias else None

    def forward(self, x, add_bias: bool = True):
        bias = self.bias.to(self.dtype) if add_bias and \
            self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def _dense(cfg: BertConfig, d_in: int, d_out: int, device,
           quantize: bool = False) -> nn.Module:
    """A projection: ``Dense``, or at a site tpudl's
    ``_dense(quantize=True)`` marks, ``Fp8Dense`` when ``cfg.fp8_train``
    is set and ``QuantDense`` when ``cfg.weight_dtype`` is."""
    if quantize and cfg.fp8_train:
        return Fp8Dense(d_in, d_out, cfg.dtype,
                        impl=fp8_train_impl(cfg.fp8_train), device=device)
    if quantize and cfg.weight_dtype is not None:
        return QuantDense(d_in, d_out, cfg.dtype, device, use_bias=True,
                          masters=True)
    return Dense(d_in, d_out, cfg.dtype, device)


class LayerNorm(nn.Module):
    """LayerNorm(+residual add) through the tpudl_torch.ops.norms seam,
    f32 ``scale``/``bias`` (flax ``nn.LayerNorm`` and tpudl's
    ``FusedLayerNorm`` share this parameter tree)."""

    def __init__(self, hidden_size: int, eps: float, impl: str, device=None):
        super().__init__()
        self.eps = eps
        self.impl = impl
        self.scale = nn.Parameter(
            torch.empty(hidden_size, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(
            torch.empty(hidden_size, dtype=torch.float32, device=device))

    def forward(self, x, residual=None, return_sum=True):
        return layer_norm(x, self.scale, self.bias, residual, eps=self.eps,
                          return_sum=return_sum, impl=self.impl)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size

        def table(rows):
            return nn.Embedding(rows, h, device=device, dtype=torch.float32)

        self.word_embeddings = table(cfg.vocab_size)
        self.position_embeddings = table(cfg.max_position_embeddings)
        self.token_type_embeddings = table(cfg.type_vocab_size)
        # The composite path's nn.LayerNorm(dtype=f32) is layer_norm_ref.
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps,
                                    fused_ops_impl(cfg.fused_ops), device)
        self.dropout = Dropout(cfg.hidden_dropout, exact=cfg.dropout_exact)

    def forward(self, input_ids, token_type_ids, train, generator):
        we = self.word_embeddings(input_ids.long())
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        pe = self.position_embeddings(pos)[None]
        # The token-type table has type_vocab_size (2) rows that a batch
        # repeats thousands of times, and the CUDA embedding backward sums
        # such a row in no fixed order. As a one-hot product the lookup is
        # exact (1 x the row plus 0 x the others) and its backward is one
        # matrix product, bitwise repeatable: what lets a captured step be
        # held to the eager one bit for bit.
        table = self.token_type_embeddings.weight
        onehot = F.one_hot(token_type_ids.long(), self.cfg.type_vocab_size)
        te = onehot.to(table.dtype) @ table
        x = self.layer_norm(we + pe + te)
        x = self.dropout(x, not train, generator)
        return x.to(self.cfg.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _dense(cfg, h, h, device, quantize=True))
        self.dropout = Dropout(cfg.hidden_dropout, exact=cfg.dropout_exact)

    def forward(self, hidden, attn_mask, train, generator):
        cfg = self.cfg
        b, s, _ = hidden.shape
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        q = self.query(hidden).view(shape)
        k = self.key(hidden).view(shape)
        v = self.value(hidden).view(shape)
        rate = cfg.attention_dropout if train else 0.0
        ctx = attend(
            q, k, v, mask=attn_mask, implementation=cfg.attention_impl,
            dropout_rate=rate, dropout_rng=generator if rate > 0.0 else None,
            dropout_exact=cfg.dropout_exact,
        )
        out = self.out(ctx.reshape(b, s, cfg.hidden_size))
        return self.dropout(out, not train, generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.impl = fused_ops_impl(cfg.fused_ops)
        self.attention = BertSelfAttention(cfg, device)
        self.attention_norm = LayerNorm(h, cfg.layer_norm_eps, self.impl, device)
        # The fused tier's intermediate is tpudl's FusedBiasGeluDense: a
        # product whose bias the bias+GeLU epilogue adds. It is no fp8
        # site, but its kernel may be quantized (quant_dot then bias+GeLU).
        self.intermediate = _dense(
            cfg, h, f, device,
            quantize=not cfg.fused_ops or cfg.weight_dtype is not None)
        self.output = _dense(cfg, f, h, device, quantize=True)
        self.dropout = Dropout(cfg.hidden_dropout, exact=cfg.dropout_exact)
        self.output_norm = LayerNorm(h, cfg.layer_norm_eps, self.impl, device)

    def forward(self, hidden, attn_mask, train, generator):
        cfg = self.cfg
        if cfg.remat == "attention" and torch.is_grad_enabled():
            attn_out = checkpointed(self.attention, generator, hidden,
                                    attn_mask, train, generator)
        else:
            attn_out = self.attention(hidden, attn_mask, train, generator)
        if cfg.fused_ops:
            # The residual add rides inside the LayerNorm kernel; BERT is
            # post-norm and never reads the summed value, so the kernel
            # skips that write. The intermediate product runs without its
            # bias, which the bias+GeLU epilogue adds in f32.
            hidden = self.attention_norm(attn_out, hidden,
                                         return_sum=False).to(cfg.dtype)
            inter = bias_gelu(self.intermediate(hidden, add_bias=False),
                              self.intermediate.bias, impl=self.impl)
            out = self.dropout(self.output(inter), not train, generator)
            hidden = self.output_norm(out, hidden,
                                      return_sum=False).to(cfg.dtype)
        else:
            hidden = self.attention_norm(hidden + attn_out).to(cfg.dtype)
            inter = F.gelu(self.intermediate(hidden), approximate="none")
            out = self.dropout(self.output(inter), not train, generator)
            hidden = self.output_norm(hidden + out).to(cfg.dtype)
        return hidden


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.num_layers = cfg.num_layers
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, device))

    def forward(self, hidden, attn_mask, train, generator):
        remat = self.cfg.remat in (True, "layer") and torch.is_grad_enabled()
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if remat:
                hidden = checkpointed(layer, generator, hidden, attn_mask,
                                      train, generator,
                                      policy=self.cfg.remat_policy)
            else:
                hidden = layer(hidden, attn_mask, train, generator)
        return hidden


class BertModel(nn.Module):
    """Embeddings + encoder + pooler ([CLS] tanh projection)."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device)
        self.encoder = BertEncoder(cfg, device)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype, device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train=False, generator=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids, train, generator)
        x = self.encoder(x, padding_mask(attention_mask), train, generator)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForSequenceClassification(nn.Module):
    """The ``configs[1]`` fine-tune model. ``forward(input_ids,
    attention_mask=None, token_type_ids=None, train=False,
    generator=None)`` returns f32 logits ``[B, num_labels]``; with
    ``train=True`` and dropout on, ``generator`` (on the model's device)
    is required. Built on ``device`` with weights drawn from torch's
    default generator; ``init_weights`` (which ``create_train_state``
    calls) redraws them from a seeded one. ``device="meta"`` gives a
    weight-free skeleton."""

    def __init__(self, cfg: BertConfig, device="cuda"):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.bert = BertModel(cfg, device)
        self.dropout = Dropout(cfg.hidden_dropout, exact=cfg.dropout_exact)
        self.classifier = Dense(cfg.hidden_size, cfg.num_labels, torch.float32,
                                device)
        # The f32 classifier product stays f32 on the card (flax
        # Dense(dtype=float32) is a full-precision dot).
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.device(device).type != "meta":
            self.init_weights(None)

    def tpudl_path(self, name: str) -> str:
        return tpudl_path(name)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """Redraw every parameter in place as tpudl's ``model.init`` does:
        normal(0.02) projections and embedding tables, zero biases, unit
        LayerNorm scales. ``generator`` lives on the model's device (None:
        torch's default generator)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                train=False, generator=None):
        _, pooled = self.bert(input_ids, attention_mask, token_type_ids,
                              train, generator)
        pooled = self.dropout(pooled, not train, generator)
        return self.classifier(pooled).float()


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

_LAYER_LEAVES = tuple(
    [f"attention.{p}.{leaf}" for p in ("query", "key", "value", "out")
     for leaf in ("weight", "bias")]
    + [f"{m}.{leaf}" for m in ("attention_norm", "output_norm")
       for leaf in ("scale", "bias")]
    + [f"{m}.{leaf}" for m in ("intermediate", "output")
       for leaf in ("weight", "bias")]
)
_TOP_LEAVES = (
    "bert.embeddings.word_embeddings.weight",
    "bert.embeddings.position_embeddings.weight",
    "bert.embeddings.token_type_embeddings.weight",
    "bert.embeddings.layer_norm.scale", "bert.embeddings.layer_norm.bias",
    "bert.pooler.weight", "bert.pooler.bias",
    "classifier.weight", "classifier.bias",
)


def tpudl_path(name: str) -> str:
    """A state_dict name's tpudl tree path, the inverse of
    ``params_from_tpudl``: ``bert.encoder.layer_0.attention.query.weight``
    -> ``bert/encoder/layer_0/attention/query/kernel``, an embedding
    table's ``weight`` -> ``embedding``."""
    module, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "embedding" if module.endswith("_embeddings") else "kernel"
    elif leaf in ("qvalues", "qscale"):
        leaf = f"kernel.{leaf}"
    return f"{module}.{leaf}".replace(".", "/")


def param_names(num_layers: int, quantized=()):
    """The state_dict keys of a BertForSequenceClassification;
    ``quantized`` names the modules whose weight is a quantized pair
    (``X.qvalues``, ``X.qscale`` in place of ``X.weight``)."""
    names = set(_TOP_LEAVES)
    for i in range(num_layers):
        names.update(f"bert.encoder.layer_{i}.{leaf}" for leaf in _LAYER_LEAVES)
    for site in quantized:
        if f"{site}.weight" in names:
            names = (names - {f"{site}.weight"}) | {f"{site}.qvalues",
                                                   f"{site}.qscale"}
    return names


def params_from_tpudl(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """Convert a tpudl ``BertForSequenceClassification`` params tree
    (nested dicts of arrays, as ``model.init(...)["params"]`` holds them)
    to this module's state_dict of f32 tensors on ``device``: Dense
    kernels ``[in, out]`` become Linear weights ``[out, in]``, embedding
    tables become ``.weight``, LayerNorm ``scale``/``bias`` keep their
    names; a quantized kernel (``kernel/qvalues``, ``kernel/qscale``)
    becomes ``X.qvalues`` (transposed, in its own int8 / float8_e4m3fn
    dtype) and ``X.qscale``. Raises on a leaf this module has no place
    for (a malformed quantized pair, an fp8 collection) and on a leaf the
    model needs that the tree lacks."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            module = ".".join(path)
            if key in ("qvalues", "qscale") and path[-1:] == ["kernel"]:
                site = ".".join(path[:-1])
                out[f"{site}.{key}"] = (
                    quantized_tensor(value).t().contiguous().to(device)
                    if key == "qvalues" else
                    torch.tensor(np.asarray(value, np.float32), device=device))
                continue
            if isinstance(value, (tuple, list)):
                raise ValueError(
                    f"tpudl leaf {'/'.join(path + [key])} is a sequence: a "
                    f"quantized kernel is the {{qvalues, qscale}} dict"
                )
            if key == "kernel":
                arr, name = np.asarray(value, np.float32).T, f"{module}.weight"
            elif key == "embedding":
                arr, name = np.asarray(value, np.float32), f"{module}.weight"
            elif key in ("scale", "bias"):
                arr, name = np.asarray(value, np.float32), f"{module}.{key}"
            else:
                raise ValueError(
                    f"tpudl leaf {'/'.join(path + [key])} has no counterpart "
                    f"in tpudl_torch's BERT"
                )
            out[name] = torch.tensor(np.ascontiguousarray(arr), device=device)

    walk(tree, [])
    layers = {int(m.group(1)) for k in out
              if (m := re.match(r"bert\.encoder\.layer_(\d+)\.", k))}
    want = param_names(max(layers) + 1 if layers else 0,
                       [k[: -len(".qvalues")] for k in out
                        if k.endswith(".qvalues")])
    unmapped = sorted(set(out) - want)
    missing = sorted(want - set(out))
    if unmapped:
        raise ValueError(f"tpudl leaves with no counterpart: {unmapped}")
    if missing:
        raise ValueError(f"tpudl tree lacks parameters: {missing}")
    return out
