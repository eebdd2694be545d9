"""Segmented LoRA: the heterogeneous-adapter batched delta over page pools
— the Hopper kernel, its plain version and the dispatch seam.

The port's counterpart of tpudl.ops.segmented_lora. Every decode
dispatch of multi-tenant serving carries ``num_slots`` requests whose
LoRA factors differ per slot; the delta of one projection site for all
of them is

    delta[b] = scale[b] * (x[b] @ A_pages(table[b])) @ B_pages(table[b])

where the factors live in page pools (one page = one rank unit: a row of
A^T, ``{"a": [NP, in]}``, and the matching row of B, ``{"b": [NP,
out]}``; f32, or int8 with f32 ``a_scale``/``b_scale`` of shape [NP],
each row dequantizing as ``q * scale``), ``table`` [B, r_max] int32 maps
each slot's rank units to pages, and ``scale`` [B] f32 is each slot's
alpha / rank. Page 0 is all zeros and never written, so ranks short of
r_max and slots without an adapter map there and add nothing.
Accumulation is f32 and the result is rounded once to x's dtype. Given
a ``base`` (the projection output the delta is added onto, in x's
dtype), the call returns ``base + delta`` rounded as the caller's add
would round it, in the same launch. tpudl_torch.serve.lora.AdapterPool
owns the pools and the table.

``segmented_lora_ref`` is the plain version (gather the pages, two f32
einsums — tpudl's reference composite). ``segmented_lora`` dispatches by
tpudl_torch.ops.norms.resolve_impl: the kernel
(``csrc/segmented_lora.cu``, which replaces ``_seg_lora_kernel``, one
launch per call) on CUDA tensors, the plain version on CPU tensors, no
fallback; ``segmented_lora.launches`` counts kernel launches. The
kernel forms each slot's coefficients once, in a thread block cluster
that reads each page of the slot once. On the card the table's entries
must lie in [0, NP): the kernel reads the pages they name unchecked (the
pool's owner builds the table; ``check_table`` holds a host copy to the
contract). Inference only: no gradient.

The serving path makes one call per projection site, 224 per decode
step of Llama-3-8B, so it holds the pools to the kernel's contract once
(``SitePools``, built by the AdapterPool) and the table and scale once
per dispatch (``batch_args``), and each call goes through ``launch``,
which checks only the activations and the base.
"""

from __future__ import annotations

import ctypes
import math
from collections.abc import Mapping

import numpy as np
import torch

from tpudl_torch.ops import _build
from tpudl_torch.ops.norms import (
    KERNEL_DTYPES,
    check_cuda_operand,
    takes_op,
)

#: Table width (rank budget) the kernel takes.
MAX_RANK = 64

_POOL_KEYS = ({"a", "b"}, {"a", "b", "a_scale", "b_scale"})


def _as_3d(x):
    """[B, H] -> [B, 1, H]; [B, S, H] passes through."""
    if x.dim() == 2:
        return x[:, None, :], True
    if x.dim() == 3:
        return x, False
    raise ValueError(f"segmented_lora takes [B, H] or [B, S, H] activations, "
                     f"got shape {tuple(x.shape)}")


def check_pools(pools) -> None:
    """Raise unless ``pools`` is one site's pool dict."""
    if set(pools) not in _POOL_KEYS:
        raise ValueError(f"pool dict must hold a/b (+ a_scale/b_scale when "
                         f"int8), got keys {sorted(pools)}")


def check_table(table, num_pages: int) -> None:
    """Raise unless every entry of a host table lies in [0, num_pages)."""
    t = np.asarray(table)
    if t.size and (t.min() < 0 or t.max() >= num_pages):
        raise ValueError(f"adapter table entries must lie in [0, {num_pages}), "
                         f"got [{t.min()}, {t.max()}]")


def segmented_lora_ref(x, pools, table, scale, base=None):
    """Plain version: gather each slot's pages and contract in f32.
    ``x`` [B, S, in] or [B, in]; returns x's dtype and shape with ``out``
    as the last dimension (``base + delta`` given a ``base``)."""
    x3, squeeze = _as_3d(x)
    table = torch.as_tensor(table, device=x.device).long()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    a = pools["a"][table].float()  # [B, P, in]
    b = pools["b"][table].float()  # [B, P, out]
    if "a_scale" in pools:
        a = a * pools["a_scale"][table][..., None]
        b = b * pools["b_scale"][table][..., None]
    coef = torch.einsum("bsh,bph->bsp", x3.float(), a)
    delta = torch.einsum("bsp,bpo->bso", coef, b)
    delta = (delta * scale[:, None, None]).to(x.dtype)
    delta = delta[:, 0, :] if squeeze else delta
    return delta if base is None else base + delta


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("segmented_lora")
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.tpudl_seg_lora.argtypes = [p] * 9 + [i32] * 8 + [p]
        lib.tpudl_seg_lora.restype = i32
        _lib = lib
    return _lib


def pool_args(pools) -> tuple:
    """Hold one site's CUDA pool dict to the kernel's contract and return
    what its launches take: ``(device, a, b, a_scale, b_scale, num_pages,
    in, out, quantized, vec)`` with the tensors as addresses (the caller
    keeps the tensors alive and never replaces them); ``vec``: the
    kernel's 16-byte paths the pools allow (bit 0: the IN side, rows of
    a; bit 1: the OUT side, rows of b)."""
    check_pools(pools)
    a, b = pools["a"], pools["b"]
    device = a.device
    quantized = "a_scale" in pools
    store = torch.int8 if quantized else torch.float32
    for name, t in (("a", a), ("b", b)):
        check_cuda_operand(t, f"pool {name}", device, store)
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"pool {name} must be a contiguous 2-D tensor")
    num_pages, fout = b.shape
    if a.shape[0] != num_pages:
        raise ValueError(f"pool a has {a.shape[0]} pages, pool b "
                         f"{num_pages}")
    scales = (None, None)
    if quantized:
        for name in ("a_scale", "b_scale"):
            check_cuda_operand(pools[name], name, device, torch.float32)
            if pools[name].shape != (num_pages,) or not pools[name].is_contiguous():
                raise ValueError(f"{name} must be a contiguous [{num_pages}] "
                                 f"tensor")
        scales = (pools["a_scale"].data_ptr(), pools["b_scale"].data_ptr())
    fin = a.shape[1]
    vec = (int(fin % 4 == 0 and a.data_ptr() % 16 == 0)
           | int(fout % 4 == 0 and b.data_ptr() % 16 == 0) << 1)
    return (device, a.data_ptr(), b.data_ptr(), *scales, num_pages, fin,
            fout, int(quantized), vec)


def batch_args(table, scale) -> tuple:
    """Hold one dispatch's CUDA ``table`` [B, r_max] int32 and ``scale``
    [B] f32 to the kernel's contract and return what its launches take:
    ``(device, table, scale, B, r_max, stream)``, the tensors as
    addresses and the current stream's handle (the caller keeps the
    tensors alive and launches on that stream). The entries must lie in
    the pools' page range (``check_table``)."""
    device = table.device
    check_cuda_operand(table, "table", device, torch.int32)
    check_cuda_operand(scale, "scale", device, torch.float32)
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous [B, r] int32 tensor")
    bsz, rank = table.shape
    if not 1 <= rank <= MAX_RANK:
        raise ValueError(f"segmented_lora kernel takes 1 <= r_max <= "
                         f"{MAX_RANK}, got {rank}")
    if scale.shape != (bsz,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous [{bsz}] tensor")
    return (device, table.data_ptr(), scale.data_ptr(), bsz, rank,
            torch.cuda.current_stream(device).cuda_stream)


def launch(x, pool, batch, base=None):
    """The kernel on pools and addressing already held to its contract
    (``pool_args``, ``batch_args``): checks only what each call brings,
    ``x`` and ``base``. The serving path's per-site entry; arguments and
    result as ``segmented_lora``'s, with ``base`` of the result's shape."""
    device, a, b, a_scale, b_scale, num_pages, fin, fout, quantized, vec = pool
    tdevice, table, scale, bsz, rank, stream = batch
    dtype = KERNEL_DTYPES.get(x.dtype)
    shape = tuple(x.shape)
    if dtype is None:
        raise ValueError(f"segmented_lora kernel takes float32 or bfloat16 "
                         f"activations, got {x.dtype}")
    if len(shape) not in (2, 3) or shape[0] != bsz or shape[-1] != fin:
        raise ValueError(f"x {shape} does not match [{bsz}, {fin}] or "
                         f"[{bsz}, S, {fin}] (the table's rows, the pools' "
                         f"in)")
    if x.device != device or tdevice != device:
        raise ValueError(f"x on {x.device}, table on {tdevice}, pools on "
                         f"{device}")
    x = x.contiguous()
    out_shape = shape[:-1] + (fout,)
    if base is not None:
        if tuple(base.shape) != out_shape or base.dtype != x.dtype or \
                base.device != device:
            raise ValueError(f"base {tuple(base.shape)} {base.dtype} on "
                             f"{base.device} is not the delta's {out_shape} "
                             f"{x.dtype} on {device}")
        base = base.contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=device)
    if not out.numel():
        return out
    if not fin:
        return out.zero_() if base is None else out.copy_(base)
    xp, op = x.data_ptr(), out.data_ptr()
    bp = 0 if base is None else base.data_ptr()
    # The 16-byte paths the pools allow, where x (IN side) and base and
    # out (OUT side) allow them too.
    vec &= int(xp % 16 == 0) | int((op | bp) % 16 == 0) << 1
    lib = _kernel()
    code = lib.tpudl_seg_lora(
        xp, a, b, a_scale, b_scale, table, scale, bp or None, op, bsz,
        shape[1] if len(shape) == 3 else 1, fin, fout, rank, vec, dtype,
        quantized, stream)
    _build.check(lib, "seg_lora", code)
    segmented_lora.launches += 1
    return out


class SitePools(Mapping):
    """One site's pool dict, held to the kernel's contract once: the
    mapping of ``{"a", "b"[, "a_scale", "b_scale"]}`` (read-only, so its
    tensors are never replaced; pages are written in place) with
    ``args``, its ``pool_args`` on CUDA (None on the CPU).
    tpudl_torch.serve.lora.AdapterPool builds its pools as these, so the
    serving path's calls skip the pool checks."""

    def __init__(self, pools):
        check_pools(pools)
        self._pools = dict(pools)
        self.args = pool_args(self._pools) if pools["a"].is_cuda else None

    def __getitem__(self, key):
        return self._pools[key]

    def __iter__(self):
        return iter(self._pools)

    def __len__(self):
        return len(self._pools)


def _seg_lora_cuda(x, pools, table, scale, base):
    pool = (pools.args if isinstance(pools, SitePools) and pools.args
            else pool_args(pools))
    batch = batch_args(table, scale)
    if base is None:
        return launch(x, pool, batch)
    out_shape = tuple(x.shape[:-1]) + (pool[7],)
    if base.numel() != math.prod(out_shape):
        raise ValueError(f"base {tuple(base.shape)} does not match the "
                         f"delta's {out_shape}")
    out = launch(x, pool, batch, base.contiguous().view(out_shape))
    return out.view(base.shape)


def segmented_lora(x, pools, table, scale, *, base=None, impl: str = "auto"):
    """``delta[b] = scale[b] * (x[b] @ A_pages(table[b])) @
    B_pages(table[b])`` for one projection site: x's dtype, shape [B, S,
    out] (or [B, out] for 2-D x); callers add it onto the base
    projection's output, or pass that output as ``base`` (x's dtype, the
    delta's shape) to get ``base + delta`` from the same call. ``table``
    [B, r_max] int32 and ``scale`` [B] f32 on x's device (the kernel path
    takes them as such; the plain version also takes host arrays). See
    the module docstring for the pool contract; ``impl``: see
    tpudl_torch.ops.norms."""
    check_pools(pools)
    if not takes_op(impl, x.device, x, base, *pools.values()):
        return segmented_lora_ref(x, pools, table, scale, base)
    from tpudl_torch.ops.library import seg_lora_op

    # The op takes tensors; host arrays (the plain version's) become
    # tensors as they are, and the kernel holds a tensor to its dtype.
    table, scale = (t if isinstance(t, torch.Tensor) else torch.as_tensor(
        np.asarray(t), device=x.device) for t in (table, scale))
    return seg_lora_op(x, pools, table, scale, base)


segmented_lora.launches = 0
