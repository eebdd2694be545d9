"""ResNet-18/34/50/101 in PyTorch, with BatchNorm state.

The port's counterpart of tpudl.models.resnet (BASELINE.json
``configs[0]`` ResNet-18 on CIFAR-10 and ``configs[2]`` ResNet-50 on
ImageNet). Numerics follow the flax model:

- the input is NHWC, as tpudl's; it is cast to ``dtype`` and permuted to
  NCHW, which is a ``channels_last`` view, so cuDNN runs every
  convolution on NHWC memory;
- parameters and BatchNorm statistics are f32 masters; every convolution
  casts its weight to ``dtype`` at use (flax ``nn.Conv(dtype=bf16)``);
- every padding is XLA's "SAME": ``total = max((ceil(n / s) - 1) * s + k
  - n, 0)``, ``total // 2`` before and the rest after. At stride 2 that
  is asymmetric (the 7x7/2 stem pads 224 by (2, 3), a 3x3/2 conv or the
  3x3/2 max pool an even input by (0, 1)), and there the input is padded
  explicitly (the max pool with -inf) before an unpadded call;
- ``BatchNorm`` is flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
  dtype=dtype)``: in training it normalizes with the batch's biased
  variance and moves its running statistics by ``0.9 * running + 0.1 *
  batch`` with that same biased variance (``nn.BatchNorm2d`` moves the
  variance with the unbiased one); statistics and the normalization are
  f32 under a bf16 input, the output is cast back to ``dtype``; in eval
  it normalizes with the running statistics;
- the last BatchNorm scale of each block starts at zero; the features are
  mean-pooled in ``dtype`` and the ``head`` computes in f32.

Parameters and buffers mirror tpudl's trees: ``ResNetBlock_0.Conv_0
.weight`` is tpudl's ``params/ResNetBlock_0/Conv_0/kernel`` (HWIO) as
OIHW, ``bn_init.mean`` is ``batch_stats/bn_init/mean``;
``params_from_tpudl`` converts a tpudl tree. Forward takes the train
step's ``generator`` keyword and draws nothing from it (a ResNet has no
dropout).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (before, after) of a length-``n`` axis under a
    window ``k`` at stride ``s``; the output has ``ceil(n / s)`` steps."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """(``x``, the symmetric padding a call takes): pads ``x`` itself
    with ``value`` where SAME padding is asymmetric on an axis."""
    (t, b), (l, r) = (same_pads(n, k, s) for n in x.shape[-2:])
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), padding="SAME",
    use_bias=False, dtype=dtype)``: an f32 master ``weight`` [out, in, k,
    k] cast to ``dtype`` (and to channels_last) at use."""

    def __init__(self, d_in: int, d_out: int, kernel: int, stride: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            d_out, d_in, kernel, kernel, dtype=torch.float32, device=device))

    def forward(self, x):
        x, pad = _same(x, self.kernel, self.stride)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x, w, None, self.stride, pad)

    def flops(self, h: int, w: int) -> Tuple[int, int, int]:
        """(multiply-add FLOPs over one image, output height, width)."""
        oh, ow = -(-h // self.stride), -(-w // self.stride)
        return 2 * oh * ow * self.weight.numel(), oh, ow


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype)`` over the
    channels of an NCHW tensor (see the module docstring): f32 ``scale``,
    ``bias`` and running ``mean`` / ``var`` buffers. ``forward(x,
    train)``; in training the running buffers move IN PLACE, and a run of
    train forwards threads them in call order (tpudl's scan carry).
    ``zero_scale`` marks a block's last norm, whose scale starts at 0."""

    MOMENTUM = 0.9
    EPS = 1e-5

    def __init__(self, features: int, zero_scale: bool = False, device=None):
        super().__init__()
        self.zero_scale = zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("mean", torch.empty(features, **f32))
        self.register_buffer("var", torch.empty(features, **f32))

    def forward(self, x, train: bool):
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                False, 0.0, self.EPS)
        # With momentum 1 the call leaves this batch's mean and unbiased
        # variance in the scratch buffers; the running update is flax's.
        c = x.shape[1]
        batch_mean = torch.zeros(c, dtype=torch.float32, device=x.device)
        batch_var = torch.zeros(c, dtype=torch.float32, device=x.device)
        y = F.batch_norm(x, batch_mean, batch_var, self.scale, self.bias,
                         True, 1.0, self.EPS)
        n = x.numel() // c
        with torch.no_grad():
            m = self.MOMENTUM
            self.mean.copy_(self.mean * m + batch_mean * (1.0 - m))
            self.var.copy_(self.var * m + batch_var * ((n - 1) / n * (1.0 - m)))
        return y


class ResNetBlock(nn.Module):
    """Basic 3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, d_in: int, filters: int, stride: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(d_in, filters, 3, stride, dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, device=device)
        _add_projection(self, d_in, filters, stride, dtype, device)

    def convs(self):
        return (self.Conv_0, self.Conv_1)

    def forward(self, x, train):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train), inplace=True)
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return F.relu(_residual(self, x, train) + y, inplace=True)


class BottleneckResNetBlock(nn.Module):
    """1x1 - 3x3 - 1x1 bottleneck block (ResNet-50/101); the stride is on
    the 3x3 convolution."""

    expansion = 4

    def __init__(self, d_in: int, filters: int, stride: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(d_in, filters, 1, 1, dtype, device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype, device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, 4 * filters, 1, 1, dtype, device)
        self.BatchNorm_2 = BatchNorm(4 * filters, zero_scale=True,
                                     device=device)
        _add_projection(self, d_in, 4 * filters, stride, dtype, device)

    def convs(self):
        return (self.Conv_0, self.Conv_1, self.Conv_2)

    def forward(self, x, train):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train), inplace=True)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train), inplace=True)
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return F.relu(_residual(self, x, train) + y, inplace=True)


def _add_projection(block, d_in, d_out, stride, dtype, device):
    """tpudl projects the residual when its shape differs from the
    block's output: a strided or widening block."""
    block.conv_proj = block.norm_proj = None
    if stride != 1 or d_in != d_out:
        block.conv_proj = Conv(d_in, d_out, 1, stride, dtype, device)
        block.norm_proj = BatchNorm(d_out, device=device)


def _residual(block, x, train):
    if block.conv_proj is None:
        return x
    return block.norm_proj(block.conv_proj(x), train)


class ResNet(nn.Module):
    """ResNet over NHWC RGB images: ``forward(x [B, H, W, 3], train=False,
    generator=None)`` returns f32 logits [B, num_classes]. Built on
    ``device`` with weights drawn from torch's default generator;
    ``init_weights`` (which ``create_train_state`` calls) redraws them
    from a seeded one. ``device="meta"`` gives a weight-free skeleton."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 small_inputs: bool = False, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.small_inputs = small_inputs
        stem = 3 if small_inputs else 7
        self.conv_init = Conv(3, num_filters, stem,
                              1 if small_inputs else 2, dtype, device)
        self.bn_init = BatchNorm(num_filters, device=device)
        self.blocks = []
        d_in, n = num_filters, 0
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                filters = num_filters * 2**i
                block = block_cls(d_in, filters, 2 if i > 0 and j == 0 else 1,
                                  dtype, device)
                self.add_module(f"{block_cls.__name__}_{n}", block)
                self.blocks.append(block)
                d_in, n = filters * block_cls.expansion, n + 1
        self.head = nn.Linear(d_in, num_classes, device=device,
                              dtype=torch.float32)
        # The f32 head stays f32 on the card (flax Dense(dtype=float32) is
        # a full-precision dot).
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.device(device).type != "meta":
            self.init_weights(None)

    def init_weights(self, generator: Optional[torch.Generator]) -> None:
        """Redraw every parameter and statistic in place as tpudl's
        ``model.init`` does: convolutions ``he_normal`` (a normal
        truncated at 2 sigma, sigma = sqrt(2 / fan_in) / 0.8796), the
        head ``lecun_normal`` (sqrt(1 / fan_in)) and a zero bias,
        BatchNorm scale 1 (0 for each block's last), bias 0, mean 0,
        var 1. ``generator`` lives on the model's device (None: torch's
        default generator)."""

        def truncated(w, variance):
            std = math.sqrt(variance) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Conv):
                    truncated(m.weight, 2.0 / m.weight[0].numel())
                elif isinstance(m, BatchNorm):
                    m.scale.fill_(0.0 if m.zero_scale else 1.0)
                    m.bias.zero_()
                    m.mean.zero_()
                    m.var.fill_(1.0)
            truncated(self.head.weight, 1.0 / self.head.in_features)
            self.head.bias.zero_()

    def forward(self, x, train: bool = False, generator=None):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), train), inplace=True)
        if not self.small_inputs:
            x, pad = _same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, pad)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean((2, 3))
        return self.head(x.float())

    def forward_flops(self, height: int, width: int) -> int:
        """The forward's convolution and dense FLOPs (2 per
        multiply-add) for one ``height`` x ``width`` image, counted from
        the shapes; pooling, BatchNorm and the activations are left out,
        as ``torch.utils.flop_counter`` leaves them."""
        flops, h, w = self.conv_init.flops(height, width)
        if not self.small_inputs:
            h, w = -(-h // 2), -(-w // 2)
        for block in self.blocks:
            h0, w0 = h, w
            for conv in block.convs():
                f, h, w = conv.flops(h, w)
                flops += f
            if block.conv_proj is not None:
                flops += block.conv_proj.flops(h0, w0)[0]
        return flops + 2 * self.head.weight.numel()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckResNetBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckResNetBlock)
#: The tiny variant of tpudl's unit tests.
ResNetTiny = partial(ResNet, stage_sizes=(1, 1), block_cls=ResNetBlock,
                     num_filters=8, small_inputs=True)

RESNET_SIZES = {"resnet18": ResNet18, "resnet34": ResNet34,
                "resnet50": ResNet50, "resnet101": ResNet101}


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def _kind(module: str) -> Optional[str]:
    last = module.rsplit(".", 1)[-1]
    if last in ("conv_init", "conv_proj") or last.startswith("Conv_"):
        return "conv"
    if last in ("bn_init", "norm_proj") or last.startswith("BatchNorm_"):
        return "norm"
    if module == "head":
        return "head"
    return None


_LEAVES = {("conv", "params"): {"kernel": "weight"},
           ("norm", "params"): {"scale": "scale", "bias": "bias"},
           ("norm", "batch_stats"): {"mean": "mean", "var": "var"},
           ("head", "params"): {"kernel": "weight", "bias": "bias"}}


def params_from_tpudl(params, batch_stats,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """Convert a tpudl ResNet's ``params`` and ``batch_stats`` trees
    (nested dicts of arrays, as ``model.init(...)`` holds them) to this
    module's state_dict of f32 tensors on ``device``: convolution kernels
    HWIO become OIHW weights, the head's kernel [in, out] becomes a
    Linear weight [out, in], BatchNorm leaves keep their names. Raises on
    a leaf this module has no place for and on a module whose leaves are
    incomplete (a BatchNorm without its statistics, a block without its
    projection's norm)."""
    out: Dict[str, torch.Tensor] = {}
    modules: Dict[str, set] = {}

    def walk(node, path, collection):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + [key], collection)
                continue
            module = ".".join(path)
            name = _LEAVES.get((_kind(module), collection), {}).get(key)
            if name is None:
                raise ValueError(
                    f"tpudl leaf {collection}/{'/'.join(path + [key])} has "
                    f"no counterpart in tpudl_torch's ResNet")
            arr = np.asarray(value, np.float32)
            if name == "weight":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            out[f"{module}.{name}"] = torch.tensor(np.ascontiguousarray(arr),
                                                   device=device)
            modules.setdefault(module, set()).add(name)

    walk(params, [], "params")
    walk(batch_stats, [], "batch_stats")
    want = {"conv": {"weight"}, "norm": {"scale", "bias", "mean", "var"},
            "head": {"weight", "bias"}}
    missing = sorted(f"{m}.{leaf}" for m, have in modules.items()
                     for leaf in want[_kind(m)] - have)
    for top in ("conv_init", "bn_init", "head"):
        if top not in modules:
            missing.append(top)
    blocks = {m.rsplit(".", 1)[0] for m in modules if "." in m}
    for block in sorted(blocks):
        convs = {m.rsplit("_", 1)[1] for m in modules
                 if m.startswith(f"{block}.Conv_")}
        norms = {m.rsplit("_", 1)[1] for m in modules
                 if m.startswith(f"{block}.BatchNorm_")}
        if convs != norms:
            missing.append(f"{block}: Conv_{sorted(convs)} vs BatchNorm_"
                           f"{sorted(norms)}")
        proj = [f"{block}.{m}" in modules for m in ("conv_proj", "norm_proj")]
        if proj[0] != proj[1]:
            missing.append(f"{block}: conv_proj without norm_proj or back")
    if missing:
        raise ValueError(f"tpudl trees lack leaves: {missing}")
    return out
