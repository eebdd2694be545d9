"""The Hopper kernels of tpudl_torch against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one. The file imports neither jax nor tpudl, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up jax.)
"""

import numpy as np
import pytest
import torch

from tpudl_torch.ops import keep_mask
from tpudl_torch.ops import softmax_dropout as sd
from tpudl_torch.ops.cross_entropy import (
    softmax_cross_entropy,
    softmax_cross_entropy_ref,
    xent_bwd,
    xent_bwd_ref,
)
from tpudl_torch.ops.mlp_fused import (
    bias_gelu,
    bias_gelu_bwd,
    bias_gelu_bwd_ref,
    bias_gelu_ref,
    swiglu,
    swiglu_ref,
)
from tpudl_torch.ops.norms import (
    layer_norm,
    layer_norm_ref,
    norm_bwd,
    norm_bwd_ref,
    norm_stats_ref,
    rms_norm,
    rms_norm_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernels run only there)")
    return torch.device("cuda", torch.cuda.current_device())


def _t(rng, shape, dtype, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=dev, dtype=dtype
    )


# f32: the kernel and the plain version differ only in summation order.
# bf16: the kernel adds the residual in f32, the plain version in bf16
# (tpudl's contract band, tests/test_fused_norms.py:148-160).
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05}


# (rows, H) of the norm forward's paths: the rows kernel (H <= 1024, one
# warp a row, up to 4 rows a warp; row counts that are not a multiple of
# a block's rows); the wide kernel (a block a row) at H 4096 at the
# decode step's 4 rows, a prefill's 130 and others, and at H 4104 (513
# bf16 vectors, 1026 f32: a ragged last vector per thread); the scalar
# path (H 100 in bf16 and 4100 in both: rows that are not whole 16-byte
# vectors).
NORM_SHAPES = [(10, 96), (10, 100), (3, 768), (517, 768), (4100, 768),
               (1, 4096), (4, 4096), (16, 4096), (24, 4096), (48, 4096),
               (130, 4096), (10, 4104), (37, 4100)]


def _norm_inputs(rng, n, h, dtype, dev, mode, shift=0.0):
    x = _t(rng, (n, h), dtype, dev) * 2 + shift
    r = _t(rng, (n, h), dtype, dev) if mode != "plain" else None
    return x, r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", NORM_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "residual", "residual_nosum"])
def test_rms_norm_kernel_matches_plain(dev, dtype, n, h, mode):
    """The forward against its plain version on every path; a second call
    gives the same bits (the cluster's partial sums are read in rank
    order, never added atomically)."""
    rng = np.random.default_rng(n * 10007 + h)
    x, r = _norm_inputs(rng, n, h, dtype, dev, mode)
    scale = _t(rng, (h,), torch.float32, dev)
    before = rms_norm.launches
    out = rms_norm(x, scale, r, eps=1e-5, return_sum=mode != "residual_nosum",
                   impl="fused")
    again = rms_norm(x, scale, r, eps=1e-5,
                     return_sum=mode != "residual_nosum", impl="fused")
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 2
    ref = rms_norm_ref(x, scale, r, eps=1e-5)
    if mode == "residual":
        (y, s), (yr, sr) = out, ref
        # The sum is x + r rounded once, in both.
        torch.testing.assert_close(s.float(), sr.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        assert torch.equal(s, again[1])
        again = again[0]
    else:
        y, yr = out, ref if mode == "plain" else ref[0]
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), yr.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(y, again)


def test_rms_norm_kernel_unaligned_rows_take_scalar_path(dev):
    """A row view that starts off a 16-byte boundary goes through the
    scalar path and still matches."""
    rng = np.random.default_rng(0)
    base = _t(rng, (3, 130), torch.float32, dev)
    x = base[:, 1:129]  # row stride 130, first element 4 bytes in
    scale = _t(rng, (128,), torch.float32, dev)
    y = rms_norm(x, scale, impl="fused")
    torch.testing.assert_close(y, rms_norm_ref(x, scale), rtol=1e-5, atol=1e-5)


def test_rms_norm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rms_norm(x, torch.ones(64, device=dev))
    x = torch.zeros(64, 4, device=dev).t()
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm(x, torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="scale"):
        rms_norm(torch.zeros(4, 64, device=dev), torch.ones(32, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        rms_norm(torch.zeros(4, 64, device=dev),
                 torch.ones(64, device=dev, dtype=torch.bfloat16))


# SwiGLU forward shapes: decode (one vector a thread, 64-thread blocks),
# a ragged tail on that path (9 x 3755), the smallest call past it (16 x
# 14336 in bf16: two vectors a thread), a prefill, the Llama LoRA step's
# [8192, 14336], a ragged tail, fewer elements than a vector.
SWIGLU_SHAPES = [(4, 14336), (9, 3755), (16, 14336), (128, 14336),
                 (8192, 14336), (3, 77), (1, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWIGLU_SHAPES)
def test_swiglu_kernel_matches_plain(dev, dtype, shape):
    rng = np.random.default_rng(shape[1])
    g = _t(rng, shape, dtype, dev) * 4
    u = _t(rng, shape, dtype, dev)
    before = swiglu.launches
    y = swiglu(g, u, impl="fused")
    again = swiglu(g, u, impl="fused")
    torch.cuda.synchronize()
    assert swiglu.launches == before + 2
    assert y.dtype == dtype and y.shape == g.shape
    torch.testing.assert_close(y.float(), swiglu_ref(g, u).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(4, 4096), (128, 4096), (517, 768),
                                 (37, 4100)])
def test_dependent_launches_back_to_back_match_serialized(dev, dtype, n, h):
    """Norm -> SwiGLU -> residual norm -> LayerNorm, each kernel fed the
    one before's output, 6 rounds, launched back to back on one stream
    (each a programmatic dependent launch that may start while the one
    before runs) and again with a synchronize after every launch, and
    replayed from a CUDA graph: all equal bit for bit. A kernel that read
    its input before griddepcontrol.wait would see it half written."""
    rng = np.random.default_rng(n + h)
    x0 = _t(rng, (n, h), dtype, dev)
    up = _t(rng, (n * h,), dtype, dev)
    s1, s2, s3, b3 = (_t(rng, (h,), torch.float32, dev) for _ in range(4))

    def chain(x, sync):
        out = []
        for _ in range(6):
            y1 = rms_norm(x, s1, impl="fused")
            sync()
            a = swiglu(y1.view(-1), up, impl="fused").view(n, h)
            sync()
            y2, summed = rms_norm(a, s2, y1, impl="fused")
            sync()
            x = layer_norm(summed, s3, b3, impl="fused")
            sync()
            out += [y1, a, y2, summed, x]
        return out

    serial = chain(x0, torch.cuda.synchronize)
    eager = chain(x0, lambda: None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(x0, lambda: None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = chain(x0, lambda: None)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(serial, eager, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)
    # And the last stage is still a normed row.
    torch.testing.assert_close(
        serial[-1].float(),
        layer_norm_ref(serial[-2], s3, b3, eps=1e-12).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_swiglu_kernel_unaligned_and_refusals(dev):
    rng = np.random.default_rng(1)
    g = _t(rng, (1001,), torch.float32, dev)[1:]
    u = _t(rng, (1001,), torch.float32, dev)[1:]
    torch.testing.assert_close(swiglu(g, u), swiglu_ref(g, u), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        swiglu(torch.zeros(8, 8, device=dev).t(), torch.zeros(8, 8, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        swiglu(torch.zeros(8, device=dev),
               torch.zeros(8, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_tiny_llama_kernel_path_matches_plain_path(dev, dtype, tol):
    """The whole decode path on the card: LLAMA_TINY with the kernels
    (fused_ops=True) and with the plain versions (fused_ops=False), same
    weights — prefill and three decode steps."""
    import importlib

    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params

    gen = importlib.import_module("tpudl_torch.models.generate")
    cfg = LLAMA_TINY(dtype=dtype, max_seq_len=64)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    models = [LlamaForCausalLM(LLAMA_TINY(dtype=dtype, max_seq_len=64,
                                          fused_ops=f), device="meta")
              for f in (True, False)]
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 512, size=(2, 8))
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    before = (rms_norm.launches, swiglu.launches)
    outs = [gen.prefill_fn(m)(params, ids, mask) for m in models]
    assert rms_norm.launches == before[0] + 2 * 2 + 1
    assert swiglu.launches == before[1] + 2
    token = outs[1][0].argmax(-1)
    position = torch.as_tensor(mask.sum(-1), device=dev)
    for _ in range(3):
        (lk, ck), (lp, cp) = outs
        torch.testing.assert_close(lk, lp, rtol=tol, atol=tol)
        outs = [gen.decode_fn(m)(params, c, token, position)
                for m, c in zip(models, (ck, cp))]
        token, position = outs[1][0].argmax(-1), position + 1
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=tol, atol=tol)


# bias+GeLU: the kernel adds the bias in f32 and rounds once, the plain
# version adds it in bf16 (tpudl's band, tests/test_fused_mlp.py:98-108).
BG_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (0.05, 0.02)}
# Backward: f32 1e-4 (tests/test_fused_norms.py:35-139); dscale, dbias and
# db are f32 sums of the same f32 terms in another order.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", NORM_SHAPES)
@pytest.mark.parametrize("mode", ["plain", "residual", "residual_nosum"])
def test_layer_norm_kernel_matches_plain(dev, dtype, n, h, mode):
    """As test_rms_norm_kernel_matches_plain, for LayerNorm (its mean
    away from 0, so the variance's clamp and cancellation show)."""
    rng = np.random.default_rng(n * 10007 + h)
    x, r = _norm_inputs(rng, n, h, dtype, dev, mode, shift=0.5)
    scale = _t(rng, (h,), torch.float32, dev)
    bias = _t(rng, (h,), torch.float32, dev)
    before = layer_norm.launches
    out = layer_norm(x, scale, bias, r, eps=1e-12,
                     return_sum=mode != "residual_nosum", impl="fused")
    again = layer_norm(x, scale, bias, r, eps=1e-12,
                       return_sum=mode != "residual_nosum", impl="fused")
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 2
    ref = layer_norm_ref(x, scale, bias, r, eps=1e-12)
    if mode == "residual":
        (y, s), (yr, sr) = out, ref
        torch.testing.assert_close(s.float(), sr.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        assert torch.equal(s, again[1])
        again = again[0]
    else:
        y, yr = out, ref if mode == "plain" else ref[0]
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), yr.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(y, again)


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(300, 768), (4, 4096), (130, 4096),
                                 (37, 4100)])
def test_norm_forward_saves_the_plain_statistics(dev, kind, dtype, n, h):
    """Under autograd the forward kernel also writes mean and rstd; they
    match the plain statistics of the f32 sum (the rows kernel, the wide
    kernel in a cluster and in a block, the scalar path)."""
    from tpudl_torch.ops.norms import _norm_fwd_cuda

    rng = np.random.default_rng(3)
    x = _t(rng, (n, h), dtype, dev)
    r = _t(rng, (n, h), dtype, dev)
    scale = _t(rng, (h,), torch.float32, dev)
    bias = _t(rng, (h,), torch.float32, dev) if kind == "layer" else None
    _, _, mean, rstd = _norm_fwd_cuda(kind, x, scale, bias, r, 1e-6, False,
                                      stats=True)
    mean_ref, rstd_ref = norm_stats_ref(x, r, kind=kind, eps=1e-6)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=1e-5)
    if kind == "layer":
        torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    else:
        assert mean is None


def _bwd_case(dev, kind, dtype, n, h, residual, with_gs, seed=0):
    rng = np.random.default_rng(seed)
    x = _t(rng, (n, h), dtype, dev)
    r = _t(rng, (n, h), dtype, dev) if residual else None
    scale = _t(rng, (h,), torch.float32, dev)
    g = _t(rng, (n, h), dtype, dev)
    gs = _t(rng, (n, h), dtype, dev) if with_gs else None
    mean, rstd = norm_stats_ref(x, r, kind=kind, eps=1e-6)
    return x, r, scale, g, gs, mean, rstd


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h", [(37, 100), (2000, 768), (64, 4096)])
@pytest.mark.parametrize("residual,with_gs", [(False, False), (True, False),
                                              (True, True)])
def test_norm_bwd_kernel_matches_plain(dev, kind, dtype, n, h, residual,
                                       with_gs):
    x, r, scale, g, gs, mean, rstd = _bwd_case(dev, kind, dtype, n, h,
                                               residual, with_gs, seed=h)
    before = norm_bwd.launches
    dx, dscale, dbias = norm_bwd(x, scale, r, mean, rstd, g, gs, kind=kind,
                                 impl="fused")
    torch.cuda.synchronize()
    assert norm_bwd.launches == before + 1
    rdx, rdscale, rdbias = norm_bwd_ref(x, scale, r, mean, rstd, g, gs,
                                        kind=kind)
    assert dx.dtype == dtype and dx.shape == x.shape
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dscale, rdscale, rtol=1e-4, atol=1e-4)
    if kind == "layer":
        torch.testing.assert_close(dbias, rdbias, rtol=1e-4, atol=1e-4)
    else:
        assert dbias is None


def test_norm_bwd_kernel_unaligned_and_strided_gradient(dev):
    """Rows off a 16-byte boundary take the scalar path; a transposed
    (non-contiguous) gradient is copied to rows first."""
    rng = np.random.default_rng(5)
    base = _t(rng, (50, 130), torch.float32, dev)
    x = base[:, 1:129]
    scale = _t(rng, (128,), torch.float32, dev)
    g = _t(rng, (128, 50), torch.float32, dev).t()
    mean, rstd = norm_stats_ref(x, kind="layer", eps=1e-6)
    got = norm_bwd(x, scale, None, mean, rstd, g, kind="layer", impl="fused")
    want = norm_bwd_ref(x, scale, None, mean, rstd, g, kind="layer")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_bwd_kernel_is_bitwise_repeatable(dev, kind):
    x, r, scale, g, gs, mean, rstd = _bwd_case(dev, kind, torch.bfloat16,
                                               8192, 768, True, False)
    a = norm_bwd(x, scale, r, mean, rstd, g, kind=kind, impl="fused")
    b = norm_bwd(x, scale, r, mean, rstd, g, kind=kind, impl="fused")
    for u, v in zip(a, b):
        if u is not None:
            assert torch.equal(u, v)


# Every route of the backward (tpudl_torch.ops.norms.bwd_plan): the rows
# route (a warp a row: H 768 and 1024, and f32 768), the wide route (a
# block a row: H 4096, f32 1024) and the scalar one (H 766, not whole
# 16-byte vectors); row counts below (37), at (1056: 264 blocks of 4 warps
# of one row) and above (3001: ragged stripes) the persistent grid; with
# and without the scale's sums (frozen scales). Each run twice, bit for
# bit.
@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [768, 1024, 4096, 766])
@pytest.mark.parametrize("n", [37, 1056, 3001])
@pytest.mark.parametrize("residual,with_gs", [(False, False), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("params", [True, False])
def test_norm_bwd_routes_match_plain_and_repeat(dev, kind, dtype, h, n,
                                                residual, with_gs, params):
    from tpudl_torch.ops.norms import _norm_bwd_cuda

    x, r, scale, g, gs, mean, rstd = _bwd_case(dev, kind, dtype, n, h,
                                               residual, with_gs, seed=n + h)
    before = norm_bwd.launches
    got = _norm_bwd_cuda(kind, x, scale, r, mean, rstd, g, gs, params)
    again = _norm_bwd_cuda(kind, x, scale, r, mean, rstd, g, gs, params)
    torch.cuda.synchronize()
    assert norm_bwd.launches == before + 2
    rdx, rdscale, rdbias = norm_bwd_ref(x, scale, r, mean, rstd, g, gs,
                                        kind=kind)
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), rdx.float(), rtol=tol, atol=tol)
    if params:
        torch.testing.assert_close(got[1], rdscale, rtol=1e-4, atol=1e-4)
        if kind == "layer":
            torch.testing.assert_close(got[2], rdbias, rtol=1e-4, atol=1e-4)
    else:
        assert got[1] is None and got[2] is None
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_norm_kernels_refuse_what_they_cannot_take(dev):
    s = torch.ones(64, device=dev)
    x = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        layer_norm(x, s, s)
    with pytest.raises(ValueError, match="bias is on cpu"):
        layer_norm(torch.zeros(4, 64, device=dev), s, torch.ones(64))
    with pytest.raises(ValueError, match="residual shape"):
        layer_norm(torch.zeros(4, 64, device=dev), s, s,
                   torch.zeros(2, 64, device=dev))
    x = torch.zeros(4, 64, device=dev)
    mean, rstd = norm_stats_ref(x, kind="layer", eps=1e-6)
    with pytest.raises(ValueError, match="g shape"):
        norm_bwd(x, s, None, mean, rstd, torch.zeros(4, 32, device=dev),
                 kind="layer")
    with pytest.raises(ValueError, match="g has dtype"):
        norm_bwd(x, s, None, mean, rstd,
                 torch.zeros(4, 64, device=dev, dtype=torch.bfloat16),
                 kind="layer")
    with pytest.raises(ValueError, match="saved mean"):
        norm_bwd(x, s, None, None, rstd, x, kind="layer")
    with pytest.raises(ValueError, match="rstd must be"):
        norm_bwd(x, s, None, mean, rstd[:2], x, kind="layer")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 3072), (3, 77), (1, 5), (2, 3, 512)])
def test_bias_gelu_kernels_match_plain(dev, dtype, shape):
    rng = np.random.default_rng(shape[-1])
    x = _t(rng, shape, dtype, dev) * 2
    b = _t(rng, shape[-1:], torch.float32, dev)
    g = _t(rng, shape, dtype, dev)
    before = (bias_gelu.launches, bias_gelu_bwd.launches)
    y = bias_gelu(x, b, impl="fused")
    dx, db = bias_gelu_bwd(x, b, g, impl="fused")
    torch.cuda.synchronize()
    assert (bias_gelu.launches, bias_gelu_bwd.launches) == (before[0] + 1,
                                                            before[1] + 1)
    rtol, atol = BG_TOL[dtype]
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), bias_gelu_ref(x, b).float(),
                               rtol=rtol, atol=atol)
    rdx, rdb = bias_gelu_bwd_ref(x, b, g)
    assert dx.dtype == dtype and db.dtype == torch.float32
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-4)


# BERT-large's widths (configs[3], a microbatch of 64 x 128 = 8192
# rows): H 1024 is the rows kernel's last width in bf16 (128 vectors a
# row, VPL 4) and takes VPL 8 in f32; the MLP's F is 4096.
BERT_LARGE_ROWS, BERT_LARGE_H, BERT_LARGE_F = 8192, 1024, 4096


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_norm_kernels_at_bert_large_width(dev, kind, dtype, residual):
    """The norm forward and backward at [8192, 1024] against their plain
    twins, each run twice for the bits."""
    n, h = BERT_LARGE_ROWS, BERT_LARGE_H
    rng = np.random.default_rng(1024)
    x, r = _norm_inputs(rng, n, h, dtype, dev,
                        "residual" if residual else "plain", shift=0.5)
    scale = _t(rng, (h,), torch.float32, dev)
    bias = _t(rng, (h,), torch.float32, dev)
    fn, ref = ((layer_norm, layer_norm_ref) if kind == "layer"
               else (rms_norm, rms_norm_ref))
    args = (x, scale, bias) if kind == "layer" else (x, scale)
    eps = 1e-12 if kind == "layer" else 1e-6
    before = fn.launches
    out = fn(*args, r, eps=eps, impl="fused")
    again = fn(*args, r, eps=eps, impl="fused")
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    want = ref(*args, r, eps=eps)
    got, want = (out, want) if r is None else (out[0], want[0])
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    if r is not None:
        torch.testing.assert_close(out[1].float(), ref(*args, r, eps=eps)[1]
                                   .float(), rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.equal(out[1], again[1])
        again = again[0]
    assert torch.equal(got, again)

    x, r, scale, g, gs, mean, rstd = _bwd_case(dev, kind, dtype, n, h,
                                               residual, False, seed=h)
    before = norm_bwd.launches
    a = norm_bwd(x, scale, r, mean, rstd, g, gs, kind=kind, impl="fused")
    b = norm_bwd(x, scale, r, mean, rstd, g, gs, kind=kind, impl="fused")
    torch.cuda.synchronize()
    assert norm_bwd.launches == before + 2
    rdx, rdscale, rdbias = norm_bwd_ref(x, scale, r, mean, rstd, g, gs,
                                        kind=kind)
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(a[0].float(), rdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(a[1], rdscale, rtol=1e-4, atol=1e-4)
    if kind == "layer":
        torch.testing.assert_close(a[2], rdbias, rtol=1e-4, atol=1e-4)
    for u, v in zip(a, b):
        if u is not None:
            assert torch.equal(u, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_gelu_kernels_at_bert_large_width(dev, dtype):
    """bias + GELU forward and backward at [8192, 4096] against the plain
    twins, each run twice for the bits."""
    rng = np.random.default_rng(BERT_LARGE_F)
    shape = (BERT_LARGE_ROWS, BERT_LARGE_F)
    x = _t(rng, shape, dtype, dev) * 2
    b = _t(rng, shape[-1:], torch.float32, dev)
    g = _t(rng, shape, dtype, dev)
    before = (bias_gelu.launches, bias_gelu_bwd.launches)
    y, y2 = (bias_gelu(x, b, impl="fused") for _ in range(2))
    (dx, db), (dx2, db2) = (bias_gelu_bwd(x, b, g, impl="fused")
                            for _ in range(2))
    torch.cuda.synchronize()
    assert (bias_gelu.launches, bias_gelu_bwd.launches) == (before[0] + 2,
                                                            before[1] + 2)
    rtol, atol = BG_TOL[dtype]
    torch.testing.assert_close(y.float(), bias_gelu_ref(x, b).float(),
                               rtol=rtol, atol=atol)
    rdx, rdb = bias_gelu_bwd_ref(x, b, g)
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(dx.float(), rdx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)
    assert torch.equal(db, db2)


def test_bias_gelu_kernels_unaligned_pointer_and_refusals(dev):
    rng = np.random.default_rng(7)
    flat = _t(rng, (1 + 40 * 64,), torch.float32, dev)
    x = flat[1:].view(40, 64)  # contiguous, 4 bytes off a 16-byte boundary
    b = _t(rng, (64,), torch.float32, dev)
    g = _t(rng, (40, 64), torch.float32, dev)
    torch.testing.assert_close(bias_gelu(x, b), bias_gelu_ref(x, b),
                               rtol=1e-5, atol=1e-5)
    for a, r in zip(bias_gelu_bwd(x, b, g), bias_gelu_bwd_ref(x, b, g)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bias_gelu(x.half(), b)
    with pytest.raises(ValueError, match="bias is on cpu"):
        bias_gelu(x, b.cpu())
    with pytest.raises(ValueError, match="bias shape"):
        bias_gelu(x, b[:32])
    with pytest.raises(ValueError, match="contiguous"):
        bias_gelu(torch.zeros(64, 40, device=dev).t(), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="g shape"):
        bias_gelu_bwd(x, b, g[:3])


def test_bias_gelu_bwd_kernel_is_bitwise_repeatable(dev):
    rng = np.random.default_rng(11)
    x = _t(rng, (4096, 3072), torch.bfloat16, dev)
    b = _t(rng, (3072,), torch.float32, dev)
    g = _t(rng, (4096, 3072), torch.bfloat16, dev)
    (dx1, db1), (dx2, db2) = (bias_gelu_bwd(x, b, g, impl="fused")
                              for _ in range(2))
    assert torch.equal(dx1, dx2) and torch.equal(db1, db2)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("form", ["layer", "layer_residual", "layer_sum",
                                  "rms", "rms_residual", "rms_sum"])
def test_norm_autograd_matches_autograd_through_plain(dev, form):
    """In f32 the autograd Function (forward kernel with statistics,
    backward kernel) gives the gradients autograd finds through the
    plain version."""
    rng = np.random.default_rng(13)
    kind = form.split("_")[0]
    use_res = form != kind
    sums = form.endswith("_sum")
    x0 = _t(rng, (6, 9, 256), torch.float32, dev)
    r0 = _t(rng, (6, 9, 256), torch.float32, dev)
    s0 = _t(rng, (256,), torch.float32, dev)
    b0 = _t(rng, (256,), torch.float32, dev)
    gy = _t(rng, (6, 9, 256), torch.float32, dev)
    gsum = _t(rng, (6, 9, 256), torch.float32, dev)
    grads = []
    for impl in ("fused", "reference"):
        x, r, s, b = (_leaf(t) for t in (x0, r0, s0, b0))
        res = r if use_res else None
        if kind == "layer":
            out = layer_norm(x, s, b, res, eps=1e-6, return_sum=sums, impl=impl)
        else:
            out = rms_norm(x, s, res, eps=1e-6, return_sum=sums, impl=impl)
        if sums:
            loss = (out[0] * gy).sum() + (out[1] * gsum).sum()
        else:
            loss = (out * gy).sum()
        loss.backward()
        grads.append([t.grad for t in (x, r, s, b)])
    for got, want in zip(*grads):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_norm_backward_with_frozen_scales_skips_their_sums(dev, kind):
    """Frozen scale and bias (the Llama LoRA path): one backward launch
    that gives the same dx bit for bit and no parameter gradients."""
    from tpudl_torch.ops.norms import _norm_bwd_cuda, _norm_fwd_cuda

    rng = np.random.default_rng(19)
    x0, r0, gy = (_t(rng, (40, 512), torch.bfloat16, dev) for _ in range(3))
    s0, b0 = (_t(rng, (512,), torch.float32, dev) for _ in range(2))
    bias = b0 if kind == "layer" else None
    _, _, mean, rstd = _norm_fwd_cuda(kind, x0, s0, bias, r0, 1e-6, False,
                                      stats=True)
    full = _norm_bwd_cuda(kind, x0, s0, r0, mean, rstd, gy, None)
    dx, ds, db = _norm_bwd_cuda(kind, x0, s0, r0, mean, rstd, gy, None,
                                params=False)
    assert ds is None and db is None
    assert torch.equal(dx, full[0])
    x, r = _leaf(x0), _leaf(r0)
    before = norm_bwd.launches
    if kind == "layer":
        y = layer_norm(x, s0, b0, r, eps=1e-6, return_sum=False)
    else:
        y = rms_norm(x, s0, r, eps=1e-6, return_sum=False)
    (y * gy).sum().backward()
    assert norm_bwd.launches == before + 1
    assert torch.equal(x.grad, full[0]) and torch.equal(r.grad, full[0])


def test_bias_gelu_autograd_matches_autograd_through_plain(dev):
    rng = np.random.default_rng(17)
    x0 = _t(rng, (5, 33, 384), torch.float32, dev) * 2
    b0 = _t(rng, (384,), torch.float32, dev)
    g = _t(rng, (5, 33, 384), torch.float32, dev)
    grads = []
    for impl in ("fused", "reference"):
        x, b = _leaf(x0), _leaf(b0)
        (bias_gelu(x, b, impl=impl) * g).sum().backward()
        grads.append((x.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_no_grad_forward_skips_the_statistics(dev):
    """Serving runs without autograd: one forward launch, no Function."""
    x = torch.randn(4, 4096, device=dev, dtype=torch.bfloat16)
    s = torch.ones(4096, device=dev, requires_grad=True)
    before = rms_norm.launches
    with torch.no_grad():
        y = rms_norm(x, s, x)
    assert rms_norm.launches == before + 1
    assert y[0].grad_fn is None


def test_tiny_bert_train_step_kernel_path_matches_plain_path(dev):
    """One train step of a small f32 BERT on the card, dropout on, with
    the kernels (fused_ops=True) and with the plain versions
    (fused_ops=False), same weights, batch and dropout seed: tpudl's bands
    for the loss (rtol 1e-4, atol 1e-5), the gradients (1e-4) and the
    parameters after the update (rtol 2e-3, atol 2e-5)."""
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BertConfig, BertForSequenceClassification
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=512, max_position_embeddings=64,
              dtype=torch.float32)
    ref = BertForSequenceClassification(BertConfig(**kw), device=dev)
    ref.init_weights(torch.Generator(dev).manual_seed(0))
    params = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    batch = next(synthetic_token_batches(8, 32, 512, seed=2))
    batch["attention_mask"][3, 17:] = 0
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"))
    tx = OptimConfig(learning_rate=1e-3, warmup_steps=0, schedule="constant",
                     weight_decay=0.01, mu_dtype="bfloat16")
    out = []
    for fused in (True, False):
        state = create_train_state(
            0, BertForSequenceClassification(BertConfig(fused_ops=fused, **kw),
                                             device="meta"),
            make_optimizer(tx), params=params, device=dev)
        before = (layer_norm.launches, norm_bwd.launches, bias_gelu.launches,
                  bias_gelu_bwd.launches)
        grads, metrics = step.grads_and_metrics(state, batch, fold_in(3, 0, dev))
        state, _ = step(state, batch, 3)
        after = (layer_norm.launches, norm_bwd.launches, bias_gelu.launches,
                 bias_gelu_bwd.launches)
        launched = tuple(a - b for a, b in zip(after, before))
        assert launched == ((10, 10, 4, 4) if fused else (0, 0, 0, 0))
        out.append((metrics["loss"], grads, state.model.state_dict()))
    (lk, gk, pk), (lp, gp, pp) = out
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-5)
    for k in gp:
        torch.testing.assert_close(gk[k], gp[k], rtol=1e-4, atol=1e-4)
    for k in pp:
        torch.testing.assert_close(pk[k], pp[k], rtol=2e-3, atol=2e-5)


# ---------------------------------------------------------------------------
# the dropout contract, softmax_dropout and the cross-entropy
# ---------------------------------------------------------------------------

#: Random123's known-answer vectors for Philox4x32-10 (counter, key).
PHILOX_KAT = [((0, 0, 0, 0), (0, 0)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2),
              ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0))]


def test_philox_device_function_matches_curand_and_the_twin(dev):
    """philox.cuh's rounds against cuRAND's curand_Philox4x32_10 and the
    plain twin (ops/keep_mask.py), on the known-answer counters and keys
    and 4096 random ones: bit for bit."""
    rng = np.random.default_rng(0)
    rows = [list(c) + list(k) for c, k in PHILOX_KAT]
    rows += rng.integers(0, 2**32, size=(4096, 6), dtype=np.uint64).tolist()
    words = torch.tensor(rows, dtype=torch.int64)
    ours, theirs = sd.philox_pair_cuda(words)
    assert torch.equal(ours, theirs)
    twin = torch.stack(keep_mask.philox4x32_10(
        *(words[:, j] for j in range(6))), 1)
    assert torch.equal(ours, twin)


def _sd_inputs(dev, shape, dtype, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    x = _t(rng, shape, torch.float32, dev).mul(scale).to(dtype)
    b, skv = shape[0], shape[-1]
    lengths = rng.integers(skv // 2, skv + 1, size=b)
    kvmask = torch.from_numpy(np.arange(skv)[None, :] < lengths[:, None]).to(dev)
    kvmask[-1] = False  # a fully masked batch entry
    return x, kvmask


def _sd_tol(dtype):
    # One bf16 step (relative), or 1e-5 in f32.
    return (2.0**-7, 1e-6) if dtype == torch.bfloat16 else (1e-5, 1e-5)


@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("skv", [128, 72, 511, 512])
@pytest.mark.parametrize("masking", ["none", "padding", "causal"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_softmax_dropout_kernels_match_plain(dev, dtype, out_dtype, skv,
                                             masking, rate):
    """Forward and backward against their plain versions with the same
    seed words: the dropped entries are the same, the values within one
    bf16 step (or 1e-5 in f32)."""
    x, kvmask = _sd_inputs(dev, (3, 2, skv, skv), dtype, seed=skv)
    mask = kvmask if masking == "padding" else None
    causal = masking == "causal"
    seed = torch.tensor([99, 2**31 + 5], dtype=torch.int64, device=dev)
    g = _t(np.random.default_rng(1), x.shape, torch.float32, dev).to(out_dtype)
    before = (sd.softmax_dropout.launches, sd.softmax_dropout_bwd.launches)
    out = sd._sd_fwd_cuda(x, mask, seed, causal, rate, out_dtype)
    dx = sd.softmax_dropout_bwd(x, mask, seed, g, causal, rate, impl="fused")
    torch.cuda.synchronize()
    assert (sd.softmax_dropout.launches,
            sd.softmax_dropout_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = sd.softmax_dropout_ref(x, mask, seed, causal, rate, out_dtype)
    want_dx = sd.softmax_dropout_bwd_ref(x, mask, seed, g, causal, rate)
    assert out.dtype == out_dtype and dx.dtype == dtype
    rtol, atol = _sd_tol(out_dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)
    if rate:
        assert torch.equal(out == 0, want == 0)
    rtol, atol = _sd_tol(dtype)
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=rtol,
                               atol=max(atol, 1e-5))
    if mask is not None:
        assert float(out[-1].float().abs().max()) == 0.0
        assert float(dx[-1].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 1, 3, 128), (3, 5, 7, 64)] + [
    (2, 3, 5, skv) for skv in (1, 4, 8, 129, 256, 384)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("masking", ["padding", "causal"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_softmax_dropout_row_layouts_match_plain(dev, dtype, shape, offset,
                                                 masking, rate):
    """The kernels' row layouts at their edges: row counts that do not fill
    a block's pass ([1, 1, 3, 128], [3, 5, 7, 64]), rows of one run, rows
    that are not a whole number of 16-byte runs, the widest geometries,
    logits and gradient one element past an aligned address (the unaligned
    path), causal with Sq < Skv, and a fully masked batch entry (the last).
    Forward and backward against the plain versions with the same seed
    words: the dropped entries equal, the values within one bf16 step (or
    1e-5 in f32), the backward bitwise repeatable."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(shape[-1] + offset)
    x = _t(rng, (n + offset,), torch.float32, dev).mul(3.0).to(dtype)
    x = x[offset:].view(shape)
    g = _t(rng, (n + offset,), torch.float32, dev).to(dtype)[offset:].view(shape)
    b, skv = shape[0], shape[-1]
    lengths = rng.integers(skv // 2, skv + 1, size=b)
    kvmask = torch.from_numpy(np.arange(skv)[None, :] < lengths[:, None]).to(dev)
    kvmask[-1] = False
    mask = kvmask if masking == "padding" else None
    causal = masking == "causal"
    seed = torch.tensor([7, 2**32 - 3], dtype=torch.int64, device=dev)
    out = sd._sd_fwd_cuda(x, mask, seed, causal, rate, dtype)
    dx = sd.softmax_dropout_bwd(x, mask, seed, g, causal, rate, impl="fused")
    again = sd.softmax_dropout_bwd(x, mask, seed, g, causal, rate, impl="fused")
    torch.cuda.synchronize()
    want = sd.softmax_dropout_ref(x, mask, seed, causal, rate, dtype)
    want_dx = sd.softmax_dropout_bwd_ref(x, mask, seed, g, causal, rate)
    rtol, atol = _sd_tol(dtype)
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=rtol,
                               atol=max(atol, 1e-5))
    if rate:
        assert torch.equal(out == 0, want == 0)
    assert torch.equal(dx, again)
    if mask is not None:
        assert float(out[-1].float().abs().max()) == 0.0
        assert float(dx[-1].float().abs().max()) == 0.0


def test_philox_keyed_block_matches_philox_block(dev):
    """philox.cuh's keyed philox_block (round keys hoisted, one
    mul.wide.u32 a product, the zero high counter words folded into the
    first round), which the softmax_dropout kernels draw with, against
    philox_block on 65536 random counters and keys (the check library
    csrc/philox_check.cu): bit for bit."""
    import ctypes

    from tpudl_torch.ops import _build

    lib = _build.load("philox_check")
    lib.tpudl_philox_keyed_pair.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.tpudl_philox_keyed_pair.restype = ctypes.c_int
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(1 << 16, 4), dtype=np.uint64)
    words[:8, 1] = 0  # counters below 2^32, as every tensor's flat quads
    inp = torch.from_numpy(words.astype(np.int64)).to(torch.int32).to(dev)
    keyed, plain = torch.empty_like(inp), torch.empty_like(inp)
    code = lib.tpudl_philox_keyed_pair(
        inp.data_ptr(), keyed.data_ptr(), plain.data_ptr(), inp.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "philox_keyed_pair", code)
    torch.cuda.synchronize()
    assert torch.equal(keyed, plain)
    assert not torch.equal(keyed[:, 0], keyed[:, 1])


def test_softmax_dropout_keep_mask_is_the_plain_mask_and_regenerates(dev):
    """At the BERT shape, zero logits (p = 1/128): the forward's kept
    entries are exactly the plain keep mask, bit for bit, at a rate within
    5 sigma of 0.9; the backward (g = 1) regenerates the same mask (g' /
    (1 - rate) recovered from dx) and is bitwise repeatable."""
    shape, rate = (256, 12, 128, 128), 0.1
    x = torch.zeros(shape, dtype=torch.float32, device=dev)
    seed = keep_mask.draw_seed(torch.Generator(dev).manual_seed(17))
    out = sd._sd_fwd_cuda(x, None, seed, False, rate, torch.float32)
    keep = keep_mask.keep_mask(seed, shape, rate)
    assert torch.equal(out != 0, keep)
    n = keep.numel()
    share = keep.float().mean().item()
    assert abs(share - 0.9) < 5 * (0.09 / n) ** 0.5
    g = torch.ones_like(x)
    dx = sd.softmax_dropout_bwd(x, None, seed, g, False, rate, impl="fused")
    # dx = p * (g' - sum(g' p)) and sum(g' p) = sum(out) for g = 1.
    g_prime = dx * 128 + out.sum(-1, keepdim=True)
    assert torch.equal(g_prime > 0.5 / (1 - rate), keep)
    again = sd.softmax_dropout_bwd(x, None, seed, g, False, rate, impl="fused")
    assert torch.equal(dx, again)


def test_softmax_dropout_autograd_matches_autograd_through_plain(dev):
    q, k, v = (_t(np.random.default_rng(i), (2, 64, 4, 32), torch.float32, dev)
               for i in range(3))
    am = torch.ones(2, 64, dtype=torch.int32, device=dev)
    am[1, 40:] = 0
    grads = []
    for impl in ("fused", "reference"):
        leaves = [_leaf(t) for t in (q, k, v)]
        out = sd.hybrid_attention(*leaves, mask=am, causal=True, impl=impl)
        (out * out).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_softmax_dropout_refusals(dev):
    x = torch.zeros(1, 2, 8, 513, device=dev)
    with pytest.raises(ValueError, match="at most 512"):
        sd.softmax_dropout(x, impl="fused")
    with pytest.raises(NotImplementedError, match="dense mask"):
        sd.softmax_dropout(x[..., :8], impl="fused",
                           mask=torch.ones(1, 2, 8, 8, dtype=torch.bool,
                                           device=dev))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sd.softmax_dropout(x.cpu(), impl="fused")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sd.softmax_dropout(x[..., :8].half(), impl="fused")
    with pytest.raises(ValueError, match="seed is on"):
        sd._sd_fwd_cuda(x[..., :8], None, torch.zeros(2, dtype=torch.int64),
                        False, 0.0, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,v", [(256, 2), (19, 1000), (7, 1003),
                                 (64, 30522), (128, 1000), (33, 256),
                                 (5, 257), (300, 7), (17, 100)])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_kernels_match_plain(dev, dtype, b, v, smoothing):
    rng = np.random.default_rng(v)
    z = _t(rng, (b, v), torch.float32, dev).mul(3).to(dtype)
    labels = torch.from_numpy(rng.integers(0, v, size=b)).to(dev)
    g = torch.from_numpy(rng.uniform(0, 2, size=b).astype(np.float32)).to(dev)
    before = (softmax_cross_entropy.launches, xent_bwd.launches)
    loss = softmax_cross_entropy(z, labels, smoothing, impl="fused")
    lse = torch.logsumexp(z.float(), -1)
    dz = xent_bwd(z, labels, lse, g, smoothing, impl="fused")
    torch.cuda.synchronize()
    assert (softmax_cross_entropy.launches, xent_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert loss.dtype == torch.float32 and dz.dtype == dtype
    torch.testing.assert_close(
        loss, softmax_cross_entropy_ref(z, labels, smoothing),
        rtol=1e-5, atol=1e-5)
    want = xent_bwd_ref(z, labels, lse, g, smoothing)
    rtol, atol = _sd_tol(dtype)
    torch.testing.assert_close(dz.float(), want.float(), rtol=rtol,
                               atol=max(atol, 1e-6))
    again = xent_bwd(z, labels, lse, g, smoothing, impl="fused")
    assert torch.equal(dz, again)
    assert torch.equal(loss, softmax_cross_entropy(z, labels, smoothing,
                                                   impl="fused"))


def test_cross_entropy_autograd_matches_plain_and_leading_dims(dev):
    rng = np.random.default_rng(3)
    z0 = _t(rng, (3, 5, 1003), torch.float32, dev)
    labels = torch.from_numpy(rng.integers(0, 1003, size=(3, 5))).to(dev)
    w = _t(rng, (3, 5), torch.float32, dev)
    grads = []
    for impl in ("fused", "reference"):
        z = _leaf(z0)
        out = softmax_cross_entropy(z, labels, 0.1, impl=impl)
        assert out.shape == (3, 5)
        (out * w).sum().backward()
        grads.append(z.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


def test_cross_entropy_allocates_no_bv_float_beyond_dz(dev):
    """Forward and backward at [4096, 30522] bf16: the peak allocation
    beyond the logits stays below dz plus one more bf16 [B, V] tensor (the
    bound the property states is one f32 [B, V])."""
    b, v = 4096, 30522
    z = torch.randn(b, v, device=dev).to(torch.bfloat16).requires_grad_(True)
    labels = torch.randint(0, v, (b,), device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    softmax_cross_entropy(z, labels, 0.1, impl="fused").mean().backward()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    dz_bytes = z.grad.numel() * z.grad.element_size()
    assert extra - dz_bytes < b * v * 2 < b * v * 4


def test_cross_entropy_refusals(dev):
    z = torch.zeros(4, 10, device=dev)
    labels = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        softmax_cross_entropy(torch.zeros(10, 4, device=dev).t(), labels,
                              impl="fused")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        softmax_cross_entropy(z.half(), labels, impl="fused")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        softmax_cross_entropy(z.cpu(), labels.cpu(), impl="fused")


def test_tiny_bert_fused_slice_step_matches_plain_path(dev):
    """One train step of a small f32 BERT on the card with the slice's
    kernels (fused_ops=True, attention_impl="fused", loss_impl="auto")
    against the plain path (fused_ops=False, attention_impl="reference",
    loss_impl="reference"), same weights and batch, attention dropout 0
    and hidden dropout 0.1 (the same masks on both paths), then one eval
    batch. Bands as the step test above."""
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.data.synthetic import synthetic_token_batches
    from tpudl_torch.models.bert import BertConfig, BertForSequenceClassification
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_eval_step,
        make_classification_train_step,
        make_optimizer,
    )

    kw = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=512, max_position_embeddings=64,
              attention_dropout=0.0, dtype=torch.float32)
    ref = BertForSequenceClassification(BertConfig(**kw), device=dev)
    ref.init_weights(torch.Generator(dev).manual_seed(0))
    params = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    batch = next(synthetic_token_batches(8, 32, 512, seed=2))
    batch["attention_mask"][3, 17:] = 0
    tx = OptimConfig(learning_rate=1e-3, warmup_steps=0, schedule="constant",
                     weight_decay=0.01, mu_dtype="bfloat16")
    keys = ("input_ids", "attention_mask")
    out = []
    for fused in (True, False):
        cfg = BertConfig(fused_ops=fused,
                         attention_impl="fused" if fused else "reference", **kw)
        state = create_train_state(
            0, BertForSequenceClassification(cfg, device="meta"),
            make_optimizer(tx), params=params, device=dev)
        loss_impl = "auto" if fused else "reference"
        step = make_classification_train_step(input_keys=keys,
                                              loss_impl=loss_impl)
        counts = lambda: (sd.softmax_dropout.launches,  # noqa: E731
                          sd.softmax_dropout_bwd.launches,
                          softmax_cross_entropy.launches, xent_bwd.launches)
        before = counts()
        grads, metrics = step.grads_and_metrics(state, batch, fold_in(3, 0, dev))
        launched = tuple(a - b for a, b in zip(counts(), before))
        assert launched == ((2, 2, 1, 1) if fused else (0, 0, 0, 0))
        state, _ = step(state, batch, 3)
        before = counts()
        ev = make_classification_eval_step(input_keys=keys,
                                           loss_impl=loss_impl)(state, batch)
        launched = tuple(a - b for a, b in zip(counts(), before))
        assert launched == ((2, 0, 1, 0) if fused else (0, 0, 0, 0))
        out.append((metrics["loss"], grads, state.model.state_dict(), ev))
    (lk, gk, pk, ek), (lp, gp, pp, ep) = out
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-5)
    for k in gp:
        torch.testing.assert_close(gk[k], gp[k], rtol=1e-4, atol=1e-4)
    for k in pp:
        torch.testing.assert_close(pk[k], pp[k], rtol=2e-3, atol=2e-5)
    torch.testing.assert_close(ek["loss"], ep["loss"], rtol=1e-4, atol=1e-5)
    assert float(ek["accuracy"]) == float(ep["accuracy"])


# ---------------------------------------------------------------------------
# the Llama LoRA slice: the SwiGLU backward and flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 14336), (3, 77), (1, 5)])
def test_swiglu_bwd_kernel_matches_plain(dev, dtype, shape):
    from tpudl_torch.ops.mlp_fused import swiglu_bwd, swiglu_bwd_ref

    rng = np.random.default_rng(shape[1] + 7)
    g, u, go = (_t(rng, shape, dtype, dev) * s for s in (4, 1, 1))
    before = swiglu_bwd.launches
    dg, du = swiglu_bwd(g, u, go, impl="fused")
    torch.cuda.synchronize()
    assert swiglu_bwd.launches == before + 1
    want = swiglu_bwd_ref(g, u, go)
    for got, ref in zip((dg, du), want):
        assert got.dtype == dtype and got.shape == g.shape
        torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    assert torch.equal(dg, swiglu_bwd(g, u, go, impl="fused")[0])


def test_swiglu_autograd_runs_the_backward_kernel(dev):
    from tpudl_torch.ops.mlp_fused import swiglu_bwd

    rng = np.random.default_rng(3)
    g = _leaf(_t(rng, (2, 3, 96), torch.bfloat16, dev) * 3)
    u = _leaf(_t(rng, (2, 3, 96), torch.bfloat16, dev))
    gy = _t(rng, (2, 3, 96), torch.bfloat16, dev)
    before = (swiglu.launches, swiglu_bwd.launches)
    (swiglu(g, u) * gy).sum().backward()
    assert (swiglu.launches, swiglu_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    g2, u2 = _leaf(g.detach()), _leaf(u.detach())
    (swiglu_ref(g2.float(), u2.float()) * gy.float()).sum().backward()
    for a, b in ((g, g2), (u, u2)):
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=0.05,
                                   atol=0.05)


def _fa_inputs(dev, b, sq, skv, h, d, dtype, masking, seed=0):
    rng = np.random.default_rng(seed)
    q = _t(rng, (b, sq, h, d), dtype, dev)
    k = _t(rng, (b, skv, h, d), dtype, dev)
    v = _t(rng, (b, skv, h, d), dtype, dev)
    do = _t(rng, (b, sq, h, d), dtype, dev)
    kvmask = None
    if masking == "padding":
        lengths = rng.integers(skv // 2, skv + 1, size=b)
        lengths[0] = 0 if b > 1 else lengths[0]  # a row with nothing to attend
        kvmask = torch.from_numpy(np.arange(skv)[None, :]
                                  < lengths[:, None]).to(dev)
    return q, k, v, do, kvmask


def _fa_ratio(got, want):
    """The worse of a row's L2 error over its L2 norm (rows over the head
    dim) and an element's error over its |want| plus its row's largest
    |want|; rows below 1e-2 of the tensor's RMS (dQ's first row, 0 up
    to f32 rounding) are held to that. Scaled by the row, not the
    tensor's largest value: causal rows that average over many keys are
    far smaller than the first."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    floor = 1e-2 * float(want.square().mean().sqrt())
    norm = want.square().sum(-1).sqrt().clamp_min(floor * want.shape[-1] ** 0.5)
    row_max = want.abs().amax(-1, keepdim=True).clamp_min(floor)
    return max(float((d.square().sum(-1).sqrt() / norm).max()),
               float((d / (want.abs() + row_max)).max()))


def _fa_close(got, want, dtype):
    """bf16: two bf16 steps (the kernel rounds p and ds relative to its
    running max, sums in another order); f32: the summation order only.
    The same check rejects a 5 % error planted on the 16 rows below the
    middle of the sequence axis (attended, and never padded here)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    ratio = _fa_ratio(got, want)
    assert ratio <= tol, f"error {ratio:.3e} of the row scale > {tol}"
    planted = got.float().clone()  # .float() of an f32 tensor is itself
    mid = got.shape[1] // 2
    planted[:, mid - 16:mid] *= 1.05
    assert _fa_ratio(planted, want) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,d", [
    (2, 128, 128, 2, 128), (1, 100, 150, 2, 64), (2, 150, 100, 1, 32),
    (1, 1000, 1500, 1, 64), (2, 64, 64, 3, 128),
    # Around the bf16 forward's 128-row q blocks and kv tiles, and causal
    # Sq != Skv with the diagonal inside a block.
    (1, 127, 127, 2, 64), (2, 129, 129, 1, 32), (1, 255, 255, 2, 128),
    (1, 257, 257, 1, 64), (1, 200, 330, 2, 128), (2, 257, 200, 1, 32),
    # Around the bf16 dK/dV kernel's kv blocks (64 rows at D 128, else
    # 128) and q tiles (64): causal Sq 1024 != Skv 2048,
    # a ragged q tile, Skv % 4 != 0 under dropout.
    (1, 1024, 2048, 1, 128), (1, 330, 330, 2, 128), (2, 97, 301, 1, 64),
    # Around the bf16 dQ launch's kv tiles (64 rows) at D 128: Skv = 63,
    # 65 and 129.
    (1, 60, 63, 2, 128), (2, 70, 65, 1, 128), (1, 130, 129, 2, 128)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masking", ["none", "padding"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_match_plain(dev, dtype, b, sq, skv, h, d, causal,
                                   masking, rate):
    from tpudl_torch.ops import flash_attention as fa

    q, k, v, do, kvmask = _fa_inputs(dev, b, sq, skv, h, d, dtype, masking)
    seed = torch.tensor([12345, 2**32 - 77], dtype=torch.int64, device=dev)
    before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
              fa.flash_attention.launches_dkv)
    o, lse = fa.flash_attention_fwd(q, k, v, kvmask, seed, causal, None, rate,
                                    impl="fused")
    wo, wlse = fa.flash_attention_ref(q, k, v, kvmask, seed, causal, None,
                                      rate)
    _fa_close(o, wo, dtype)
    torch.testing.assert_close(lse, wlse, rtol=1e-5, atol=1e-4)
    delta = fa.backward_delta(do, o)
    grads = fa.flash_attention_bwd(q, k, v, kvmask, seed, do, lse, delta,
                                   causal, None, rate, impl="fused")
    want = fa.flash_attention_bwd_ref(q, k, v, kvmask, seed, do, lse, delta,
                                      causal, None, rate)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
            fa.flash_attention.launches_dkv) == tuple(x + 1 for x in before)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        _fa_close(got, ref, dtype)
    again = fa.flash_attention_bwd(q, k, v, kvmask, seed, do, lse, delta,
                                   causal, None, rate, impl="fused")
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


def _attended(kvmask, b, h, sq, skv, causal, dev):
    """[b, h, sq, skv] bool: the (q, kv) pairs that attend."""
    keep = torch.ones(b, h, sq, skv, dtype=torch.bool, device=dev)
    if kvmask is not None:
        keep = keep & kvmask[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        keep = keep & (torch.arange(skv, device=dev)[None, :] <= qi)
    return keep


def _unpack_words(words, skv):
    """keep_words' int32 [..., W] as bool [..., skv]."""
    u = words.long() & 0xFFFFFFFF
    bits = (u[..., None] >> torch.arange(32, device=words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :skv].bool()


@pytest.mark.parametrize("kind,b,sq,skv,h,d,causal,masking", [
    ("flash", 2, 300, 301, 2, 128, True, "padding"),
    ("flash", 1, 130, 97, 3, 64, False, "none"),
    ("flash", 2, 257, 200, 2, 32, True, "none"),
    ("whole", 2, 301, 301, 2, 64, False, "padding"),
    ("whole", 1, 384, 384, 2, 128, True, "none")])
def test_bf16_dq_launches_write_the_plain_keep_words(dev, kind, b, sq, skv, h,
                                                     d, causal, masking):
    """The keep bits the bf16 dQ launches draw and write in row order for
    their dK/dV launches are ``keep_mask.keep_words``' on every pair that
    attends (Skv % 32 != 0, Skv % 4 != 0 among the shapes)."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    q, k, v, do, kvmask = _fa_inputs(dev, b, sq, skv, h, d, torch.bfloat16,
                                     masking, seed=21)
    seed = torch.tensor([4242, 2**32 - 5], dtype=torch.int64, device=dev)
    rate = 0.1
    if kind == "flash":
        o, lse = fa.flash_attention_fwd(q, k, v, kvmask, seed, causal, None,
                                        rate, impl="fused")
        ops = fa.bwd_operands(q, k, v, kvmask, seed, do, lse,
                              fa.backward_delta(do, o))
        bits = fa.keep_scratch(q, k, rate)
        fa.launch_dq(ops, kvmask, seed, causal, d ** -0.5, rate, bits)
    else:
        o, lse = fu.fused_attention_fwd(q, k, v, kvmask, seed, causal, None,
                                        rate, impl="fused")
        bits = fa.keep_scratch(q, k, rate)
        fu._bwd_cuda(q, k, v, kvmask, seed, do, lse, causal, d ** -0.5, rate,
                     bits)
    torch.cuda.synchronize()
    want = keep_mask.keep_words(seed, b, h, sq, skv, rate, dev)
    attended = _attended(kvmask, b, h, sq, skv, causal, dev)
    got, ref = _unpack_words(bits, skv), _unpack_words(want, skv)
    assert bool(attended.any())
    assert torch.equal(got[attended], ref[attended])


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,masking", [(True, "padding"),
                                            (False, "padding"),
                                            (True, "none")])
def test_flash_dkv_reads_only_the_keep_words_dq_wrote(dev, d, causal,
                                                      masking):
    """The flash dK/dV launch reads its keep bits from the scratch the dQ
    launch wrote, and never consults a word the dQ launch left unwritten
    for a pair that attends: with the scratch's other words poisoned (all
    ones, then all zeros) before the dQ launch, dk and dv are bitwise the
    same, and they pass the plain version's gate."""
    from tpudl_torch.ops import flash_attention as fa

    b, sq, skv, h, rate = 2, 300, 333, 2, 0.1
    q, k, v, do, kvmask = _fa_inputs(dev, b, sq, skv, h, d, torch.bfloat16,
                                     masking, seed=23)
    seed = torch.tensor([99, 2**31 + 17], dtype=torch.int64, device=dev)
    args = (kvmask, seed, causal, d ** -0.5, rate)
    o, lse = fa.flash_attention_fwd(q, k, v, *args, impl="fused")
    delta = fa.backward_delta(do, o)
    ops = fa.bwd_operands(q, k, v, kvmask, seed, do, lse, delta)
    grads = []
    for poison in (-1, 0):
        bits = fa.keep_scratch(q, k, rate).fill_(poison)
        fa.launch_dq(ops, *args, bits)
        grads.append(fa.launch_dkv(ops, *args, bits))
    assert all(torch.equal(a, b_) for a, b_ in zip(*grads))
    _, wdk, wdv = fa.flash_attention_bwd_ref(q, k, v, kvmask, seed, do, lse,
                                             delta, causal, None, rate)
    _fa_close(grads[0][0], wdk, torch.bfloat16)
    _fa_close(grads[0][1], wdv, torch.bfloat16)
    with pytest.raises(ValueError, match="keep-bit scratch"):
        fa.launch_dkv(ops, *args)


@pytest.mark.parametrize("kind", ["flash", "whole"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,rate", [(False, 0.1), (True, 0.0)])
def test_bf16_forwards_are_bitwise_repeatable(dev, kind, d, causal, rate):
    """The bf16 forwards (TMA, wgmma, a warp-specialised pipeline) give the
    same bits on every call: no atomics, one owner per output row."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    fwd = fa.flash_attention_fwd if kind == "flash" else fu.fused_attention_fwd
    q, k, v, _, kvmask = _fa_inputs(dev, 2, 300, 300, 3, d, torch.bfloat16,
                                    "padding", seed=11)
    seed = torch.tensor([777, 2**31 + 3], dtype=torch.int64, device=dev)
    o, lse = fwd(q, k, v, kvmask, seed, causal, None, rate, impl="fused")
    for _ in range(3):
        o2, lse2 = fwd(q, k, v, kvmask, seed, causal, None, rate,
                       impl="fused")
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("kind", ["flash", "whole"])
def test_dropout_draw_is_the_plain_mask_at_unaligned_rows(dev, kind):
    """At Skv = 150 (not a multiple of 4) a row's four-element groups
    straddle two Philox blocks: the forwards' keep bits are still the
    plain keep mask's, bit for bit (the window probe: q = k = 0, values
    one-hot over a 50-column window)."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    fwd = fa.flash_attention_fwd if kind == "flash" else fu.fused_attention_fwd
    b, s, h, d, w, rate = 2, 150, 3, 64, 50, 0.1
    seed = keep_mask.draw_seed(torch.Generator(device=dev).manual_seed(8))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device=dev)
    eye = torch.eye(d, dtype=torch.bfloat16, device=dev)[:w]
    v = eye.repeat(s // w, 1)[None, :, None, :].expand(b, s, h, d).contiguous()
    kept = torch.empty(b, h, s, s, dtype=torch.bool, device=dev)
    for i in range(s // w):
        window = torch.zeros(b, s, dtype=torch.bool, device=dev)
        window[:, i * w:(i + 1) * w] = True
        o, _ = fwd(q, q, v, window, seed, False, None, rate, impl="fused")
        kept[..., i * w:(i + 1) * w] = (o[..., :w] != 0).permute(0, 2, 1, 3)
    assert torch.equal(kept, keep_mask.keep_mask(seed, (b, h, s, s), rate))


def test_flash_fully_masked_rows_give_zero_and_mask_value(dev):
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops.attention import MASK_VALUE

    # Sq > Skv, causal: the first Sq - Skv rows attend to nothing.
    q, k, v, _, _ = _fa_inputs(dev, 1, 80, 50, 2, 64, torch.bfloat16, "none")
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True, impl="fused")
    assert float(o[:, :30].float().abs().max()) == 0.0
    assert bool((lse[:, :, :30] == MASK_VALUE).all())
    assert bool((lse[:, :, 30:] > -1e30).all())


def test_flash_dropout_keep_mask_is_the_plain_mask(dev):
    """Uniform logits (q = 0) and one-hot values: with the kv mask open on
    one window of 64 columns at a time, o is nonzero exactly where the
    kernel kept the entry; the union over windows is the plain keep mask
    bit for bit, and the backward is bitwise repeatable."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import keep_mask

    b, s, h, d, rate = 2, 256, 3, 64, 0.1
    seed = keep_mask.draw_seed(torch.Generator(device=dev).manual_seed(5))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device=dev)
    k = torch.zeros_like(q)
    eye = torch.eye(d, dtype=torch.bfloat16, device=dev)
    v = eye.repeat(s // d, 1)[None, :, None, :].expand(b, s, h, d).contiguous()
    kept = torch.empty(b, h, s, s, dtype=torch.bool, device=dev)
    for w in range(s // d):
        window = torch.zeros(b, s, dtype=torch.bool, device=dev)
        window[:, w * d:(w + 1) * d] = True
        o, _ = fa.flash_attention_fwd(q, k, v, window, seed, False, None, rate,
                                      impl="fused")
        kept[..., w * d:(w + 1) * d] = (o != 0).permute(0, 2, 1, 3)
    want = keep_mask.keep_mask(seed, (b, h, s, s), rate)
    assert torch.equal(kept, want)
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) < 5 * (rate * (1 - rate) / kept.numel()) ** 0.5


def test_flash_dropout_matches_hybrid_attention_on_the_same_seed(dev):
    from tpudl_torch.ops import flash_attention as fa

    rng = np.random.default_rng(4)
    q, k, v = (_t(rng, (2, 128, 4, 64), torch.float32, dev) for _ in range(3))
    am = torch.ones(2, 128, dtype=torch.int32, device=dev)
    am[1, 90:] = 0
    got = fa.flash_attention(q, k, v, am, dropout_rate=0.1,
                             dropout_rng=torch.Generator(device=dev).manual_seed(9))
    want = sd.hybrid_attention(q, k, v, mask=am, dropout_rate=0.1,
                               dropout_rng=torch.Generator(device=dev).manual_seed(9))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_autograd_matches_plain_and_lse_cotangent(dev):
    from tpudl_torch.ops import flash_attention as fa

    q, k, v, do, kvmask = _fa_inputs(dev, 2, 96, 96, 2, 64, torch.float32,
                                     "padding", seed=3)
    gl = torch.randn(2, 2, 96, device=dev)
    outs = {}
    for impl in ("fused", "reference"):
        leaves = [_leaf(t) for t in (q, k, v)]
        o, lse = fa.flash_attention_with_lse(*leaves, kvmask, causal=True,
                                             impl=impl)
        ((o * do).sum() + (torch.where(lse > -1e30, lse, 0.0) * gl).sum()
         ).backward()
        outs[impl] = [o, lse] + [t.grad for t in leaves]
    for got, want in zip(outs["fused"], outs["reference"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_refusals(dev):
    from tpudl_torch.ops import flash_attention as fa

    x = torch.zeros(1, 8, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(x, x, x)
    x = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(x, x, x)
    x = torch.zeros(1, 8, 2, 64, device=dev)
    with pytest.raises(NotImplementedError, match="dense mask"):
        fa.flash_attention(x, x, x, torch.ones(1, 2, 8, 8, dtype=torch.bool,
                                               device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [
    (2, 300, 2, 64), (2, 384, 3, 32), (1, 512, 2, 128), (2, 257, 1, 64),
    (1, 40, 2, 64),
    # Around the bf16 forward's 128-row q blocks and kv tiles.
    (1, 127, 2, 64), (2, 129, 1, 32), (1, 255, 2, 128), (1, 257, 2, 128),
    # Around the bf16 backward's tiles (dQ: 64-row kv tiles; dK/dV: kv
    # blocks of 64 rows at D 128, else 128): S 384 at D 128, a ragged q
    # tile, S % 4 != 0 under dropout.
    (2, 384, 2, 128), (1, 330, 2, 128), (2, 301, 2, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masking", ["none", "padding"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_attention_kernels_match_plain(dev, dtype, b, s, h, d, causal,
                                             masking, rate):
    """The whole-row forward and the two-launch backward against their
    plain versions (the flash gate: rows and elements relative to the
    row's scale, a planted 5 % error rejected), each backward bitwise
    repeatable."""
    from tpudl_torch.ops import fused_attention as fu

    q, k, v, do, kvmask = _fa_inputs(dev, b, s, s, h, d, dtype, masking)
    seed = torch.tensor([4242, 2**32 - 5], dtype=torch.int64, device=dev)
    before = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd.launches)
    o, lse = fu.fused_attention_fwd(q, k, v, kvmask, seed, causal, None,
                                    rate, impl="fused")
    wo, wlse = fu.fused_attention_ref(q, k, v, kvmask, seed, causal, None,
                                      rate)
    _fa_close(o, wo, dtype)
    torch.testing.assert_close(lse, wlse, rtol=1e-5, atol=1e-4)
    grads = fu.fused_attention_bwd(q, k, v, kvmask, seed, do, lse, causal,
                                   None, rate, impl="fused")
    want = fu.fused_attention_bwd_ref(q, k, v, kvmask, seed, do, lse, causal,
                                      None, rate)
    torch.cuda.synchronize()
    assert (fu.fused_attention_fwd.launches,
            fu.fused_attention_bwd.launches) == tuple(x + 1 for x in before)
    for got, ref in zip(grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        _fa_close(got, ref, dtype)
    again = fu.fused_attention_bwd(q, k, v, kvmask, seed, do, lse, causal,
                                   None, rate, impl="fused")
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


@pytest.mark.parametrize("kind,sq,causal", [("whole", 384, False),
                                             ("flash", 384, False),
                                             ("flash", 256, True)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_dead_kv_blocks_get_exact_zero_dk_dv(dev, kind, sq, causal, d,
                                                  rate):
    """A batch row whose padding leaves whole kv blocks dead (kv rows 128
    .. 383 of row 0): the bf16 dK/dV kernel writes exact zeros there and
    runs no product; the other row's gradients there are not zero, and
    every gradient passes the plain version's gate."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    skv = 384
    rng = np.random.default_rng(21)
    q, do = (_t(rng, (2, sq, 2, d), torch.bfloat16, dev) for _ in range(2))
    k, v = (_t(rng, (2, skv, 2, d), torch.bfloat16, dev) for _ in range(2))
    kvmask = torch.ones(2, skv, dtype=torch.bool, device=dev)
    kvmask[0, 100:] = False
    seed = torch.tensor([99, 2**32 - 11], dtype=torch.int64, device=dev)
    if kind == "whole":
        o, lse = fu.fused_attention_fwd(q, k, v, kvmask, seed, causal, None,
                                        rate, impl="fused")
        args = (q, k, v, kvmask, seed, do, lse, causal, None, rate)
        grads = fu.fused_attention_bwd(*args, impl="fused")
        want = fu.fused_attention_bwd_ref(*args)
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, kvmask, seed, causal, None,
                                        rate, impl="fused")
        delta = fa.backward_delta(do, o)
        args = (q, k, v, kvmask, seed, do, lse, delta, causal, None, rate)
        grads = fa.flash_attention_bwd(*args, impl="fused")
        want = fa.flash_attention_bwd_ref(*args)
    for got, ref in zip(grads, want):
        _fa_close(got, ref, torch.bfloat16)
    for g in grads[1:]:
        assert not bool(g[0, 128:].any())
        assert bool(g[1, 128:].any())


@pytest.mark.parametrize("kind,s,d", [("whole", 384, 64), ("whole", 301, 128),
                                      ("flash", 384, 128), ("flash", 257, 64)])
def test_bf16_dropout_gradients_match_hybrid_attention_on_the_same_seed(
        dev, kind, s, d):
    """The bf16 backward kernels regenerate the forward's keep mask: with
    dropout on, their output and gradients are hybrid_attention's (in f32,
    on the same bf16 values and the same seed words) within the bf16
    gate, at S % 4 == 0 and != 0 (a row's Philox blocks straddle). Flash's
    dq is left out here: its delta is tpudl's sum(do * o) of the bf16 o,
    which the f32 reference does not share. test_flash_kernels_match_plain
    holds it against its plain version under dropout and causal masking."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    rng = np.random.default_rng(13)
    q, k, v, do = (_t(rng, (2, s, 2, d), torch.bfloat16, dev)
                   for _ in range(4))
    am = torch.ones(2, s, dtype=torch.int32, device=dev)
    am[1, s - 70:] = 0
    fn = fu.fused_attention if kind == "whole" else fa.flash_attention
    outs = []
    for f, dtype in ((fn, torch.bfloat16), (sd.hybrid_attention, torch.float32)):
        leaves = [_leaf(t.to(dtype)) for t in (q, k, v)]
        o = f(*leaves, am, causal=True, dropout_rate=0.1,
              dropout_rng=torch.Generator(device=dev).manual_seed(15))
        (o.float() * do.float()).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    if kind == "flash":
        outs = [[o, dk, dv] for o, _, dk, dv in outs]
    for got, want in zip(*outs):
        _fa_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("kind", ["flash", "whole"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_causal_left_padding_gradients_match_plain(dev, kind, d, rate):
    """Causal masking with left padding (the first 96 kv rows of batch row
    0 dead, the first 200 of row 1): at D <= 64 a dK/dV block's first 64
    kv rows are dead while its next 64 are not, so both consumer
    warpgroups skip the block's first q tile (their rows dead, or past
    the tile's reach). The slot ring must stay in step all the same: the
    gradients pass the plain version's gate and repeat bit for bit over
    eight more calls."""
    from tpudl_torch.ops import flash_attention as fa
    from tpudl_torch.ops import fused_attention as fu

    s = 384
    rng = np.random.default_rng(31)
    q, k, v, do = (_t(rng, (2, s, 2, d), torch.bfloat16, dev)
                   for _ in range(4))
    kvmask = torch.ones(2, s, dtype=torch.bool, device=dev)
    kvmask[0, :96] = False
    kvmask[1, :200] = False
    seed = torch.tensor([5150, 2**32 - 3], dtype=torch.int64, device=dev)
    if kind == "whole":
        o, lse = fu.fused_attention_fwd(q, k, v, kvmask, seed, True, None,
                                        rate, impl="fused")
        args = (q, k, v, kvmask, seed, do, lse, True, None, rate)

        def bwd():
            return fu.fused_attention_bwd(*args, impl="fused")
        want = fu.fused_attention_bwd_ref(*args)
    else:
        o, lse = fa.flash_attention_fwd(q, k, v, kvmask, seed, True, None,
                                        rate, impl="fused")
        args = (q, k, v, kvmask, seed, do, lse, fa.backward_delta(do, o),
                True, None, rate)

        def bwd():
            return fa.flash_attention_bwd(*args, impl="fused")
        want = fa.flash_attention_bwd_ref(*args)
    grads = bwd()
    for got, ref in zip(grads, want):
        _fa_close(got, ref, torch.bfloat16)
    for _ in range(8):
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, bwd()))


def test_fused_attention_rows_that_keep_nothing(dev):
    from tpudl_torch.ops import fused_attention as fu
    from tpudl_torch.ops.attention import MASK_VALUE

    q, k, v, _, kvmask = _fa_inputs(dev, 2, 300, 300, 2, 64, torch.bfloat16,
                                    "padding")
    seed = torch.zeros(2, dtype=torch.int64, device=dev)
    o, lse = fu.fused_attention_fwd(q, k, v, kvmask, seed, impl="fused")
    assert not bool(kvmask[0].any())  # _fa_inputs empties batch row 0
    assert float(o[0].float().abs().max()) == 0.0
    assert bool((lse[0] == MASK_VALUE).all())
    assert bool((lse[1] > -1e30).all())


def test_fused_attention_keep_mask_is_the_plain_mask(dev):
    """Flash's window probe at S = 384: uniform logits, one-hot values, the
    kv mask open on one 64-column window at a time; the union of the
    kept entries is the plain keep mask bit for bit."""
    from tpudl_torch.ops import fused_attention as fu

    b, s, h, d, rate = 2, 384, 3, 64, 0.1
    seed = keep_mask.draw_seed(torch.Generator(device=dev).manual_seed(6))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16, device=dev)
    eye = torch.eye(d, dtype=torch.bfloat16, device=dev)
    v = eye.repeat(s // d, 1)[None, :, None, :].expand(b, s, h, d).contiguous()
    kept = torch.empty(b, h, s, s, dtype=torch.bool, device=dev)
    for w in range(s // d):
        window = torch.zeros(b, s, dtype=torch.bool, device=dev)
        window[:, w * d:(w + 1) * d] = True
        o, _ = fu.fused_attention_fwd(q, q, v, window, seed, False, None,
                                      rate, impl="fused")
        kept[..., w * d:(w + 1) * d] = (o != 0).permute(0, 2, 1, 3)
    assert torch.equal(kept, keep_mask.keep_mask(seed, (b, h, s, s), rate))
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) < 5 * (rate * (1 - rate) / kept.numel()) ** 0.5


def test_fused_attention_matches_hybrid_attention_on_the_same_seed(dev):
    from tpudl_torch.ops import fused_attention as fu

    rng = np.random.default_rng(7)
    q, k, v = (_t(rng, (2, 128, 4, 64), torch.float32, dev) for _ in range(3))
    am = torch.ones(2, 128, dtype=torch.int32, device=dev)
    am[1, 90:] = 0
    outs = []
    for fn in (fu.fused_attention, sd.hybrid_attention):
        leaves = [_leaf(t) for t in (q, k, v)]
        o = fn(*leaves, am, causal=True, dropout_rate=0.1,
               dropout_rng=torch.Generator(device=dev).manual_seed(9))
        (o * o).sum().backward()
        outs.append([o] + [t.grad for t in leaves])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_attention_autograd_matches_plain(dev):
    from tpudl_torch.ops import fused_attention as fu

    q, k, v, do, kvmask = _fa_inputs(dev, 2, 320, 320, 2, 64, torch.float32,
                                     "padding", seed=8)
    outs = {}
    for impl in ("fused", "reference"):
        leaves = [_leaf(t) for t in (q, k, v)]
        o = fu.fused_attention(*leaves, kvmask, causal=True, impl=impl)
        (o * do).sum().backward()
        outs[impl] = [o] + [t.grad for t in leaves]
    for got, want in zip(outs["fused"], outs["reference"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_attention_refusals(dev):
    from tpudl_torch.ops import fused_attention as fu

    x = torch.zeros(1, 300, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fu.fused_attention(x, x, x)
    x = torch.zeros(1, 300, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fu.fused_attention(x, x, x)
    x = torch.zeros(1, 520, 2, 64, device=dev)
    with pytest.raises(ValueError, match="S=520 > 512"):
        fu.fused_attention(x, x, x)
    x = torch.zeros(1, 300, 2, 64, device=dev)
    with pytest.raises(NotImplementedError, match="dense mask"):
        fu.fused_attention(x, x, x, torch.ones(1, 2, 300, 300,
                                               dtype=torch.bool, device=dev))


def _seg_inputs(dev, x_shape, dtype, quantized, rank, out, seed=0):
    """Pools of 40 pages (page 0 zero), a table with full, short and empty
    rows, per-slot scales, and x."""
    from tpudl_torch.serve.lora import _quantize_rows

    rng = np.random.default_rng(seed)
    fin, b = x_shape[-1], x_shape[0]
    a = rng.normal(size=(40, fin)).astype(np.float32)
    bp = rng.normal(size=(40, out)).astype(np.float32)
    a[0] = bp[0] = 0.0
    if quantized:
        (qa, sa), (qb, sb) = _quantize_rows(a), _quantize_rows(bp)
        pools = {"a": qa, "b": qb, "a_scale": sa, "b_scale": sb}
    else:
        pools = {"a": a, "b": bp}
    pools = {k: torch.from_numpy(v).to(dev) for k, v in pools.items()}
    table = rng.integers(1, 40, size=(b, rank)).astype(np.int32)
    table[b // 2:, rank // 2:] = 0  # short ranks
    table[-1] = 0  # an empty slot
    scale = rng.uniform(0.5, 2.0, size=b).astype(np.float32)
    x = _t(rng, x_shape, dtype, dev)
    return (x, pools, torch.from_numpy(table).to(dev),
            torch.from_numpy(scale).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("x_shape,rank,out", [
    ((4, 96), 16, 1100), ((4, 5, 96), 3, 40), ((2, 40, 600), 16, 300),
    ((1, 17, 1030), 8, 2049), ((3, 97), 5, 64),
    # The serving widths: decode q_proj, gate/up and down_proj at 4 slots,
    # a 128-token prefill; rank 64 (the kernel's table width) at 8 slots;
    # an IN and an OUT that no cluster slice divides.
    ((4, 4096), 16, 4096), ((4, 4096), 16, 14336), ((4, 14336), 16, 4096),
    ((1, 128, 4096), 16, 4096), ((8, 4096), 64, 4096),
    ((2, 4100), 64, 1030)])
@pytest.mark.parametrize("with_base", [False, True])
def test_segmented_lora_kernel_matches_plain(dev, dtype, quantized, x_shape,
                                             rank, out, with_base):
    from tpudl_torch.ops import segmented_lora as sl

    x, pools, table, scale = _seg_inputs(dev, x_shape, dtype, quantized, rank,
                                         out)
    base = None
    if with_base:
        base = _t(np.random.default_rng(9), x_shape[:-1] + (out,), dtype, dev)
    before = sl.segmented_lora.launches
    got = sl.segmented_lora(x, pools, table, scale, base=base, impl="fused")
    torch.cuda.synchronize()
    assert sl.segmented_lora.launches == before + 1
    want = sl.segmented_lora_ref(x, pools, table, scale, base)
    assert got.dtype == dtype and got.shape == want.shape
    # f32: the summation order only; bf16: one rounding of the same f32
    # value (two with a base), so at most one bf16 step apart each.
    tol = 2e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))
    # The empty slot adds nothing.
    assert torch.equal(got[-1], torch.zeros_like(got[-1]) if base is None
                       else base[-1])
    assert torch.equal(got, sl.segmented_lora(x, pools, table, scale,
                                              base=base, impl="fused"))


def test_segmented_lora_kernel_refusals(dev):
    from tpudl_torch.ops import segmented_lora as sl

    x, pools, table, scale = _seg_inputs(dev, (2, 64), torch.float32, False,
                                         4, 32)
    with pytest.raises(ValueError, match="r_max <= 64"):
        sl.segmented_lora(x, pools, torch.zeros(2, 65, dtype=torch.int32,
                                                device=dev), scale)
    with pytest.raises(ValueError, match="dtype torch.int64"):
        sl.segmented_lora(x, pools, table.long(), scale)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sl.segmented_lora(x.half(), pools, table, scale)
    with pytest.raises(ValueError, match="does not match"):
        sl.segmented_lora(torch.zeros(2, 63, device=dev), pools, table, scale)


def test_tiny_multi_tenant_session_on_the_card(dev):
    """LLAMA_TINY in f32 with three tenants (one of rank 2 under r_max 4)
    served on the card through the kernels: exact tokens against the
    merged-adapter reference, and the CPU plain path's tokens."""
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params
    from tpudl_torch.ops import segmented_lora as sl
    from tpudl_torch.serve import Request, ServeSession, assert_tenant_parity

    cfg = LLAMA_TINY(dtype=torch.float32, max_seq_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = LlamaForCausalLM(cfg, device="meta")
    rng = np.random.default_rng(1)
    shapes = {"attention.q_proj": (128, 128), "attention.k_proj": (128, 64),
              "attention.v_proj": (128, 64), "attention.o_proj": (128, 128),
              "gate_proj": (128, 256), "up_proj": (128, 256),
              "down_proj": (256, 128)}
    adapters = {t: {f"model.layer_{i}.{site}": {
        "lora_a": rng.normal(0, 1 / r, (fi, r)).astype(np.float32),
        "lora_b": rng.normal(0, 0.05, (r, fo)).astype(np.float32)}
        for i in range(cfg.num_layers) for site, (fi, fo) in shapes.items()}
        for t, r in (("a", 4), ("b", 2), ("c", 4))}
    reqs = [Request(f"r{i}", rng.integers(1, 512, size=int(
        rng.integers(2, 9))).tolist(), max_new_tokens=int(rng.integers(3, 10)),
        tenant=[None, "a", "b", "c"][i % 4]) for i in range(9)]
    out = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        session = ServeSession.from_model(model, p, prompt_len=8, num_slots=3,
                                          adapters=adapters, adapter_pages=9,
                                          page_size=4)
        before = sl.segmented_lora.launches
        assert_tenant_parity(session, model, p, adapters,
                             [Request(**r.__dict__) for r in reqs])
        launched = sl.segmented_lora.launches - before
        eng = session.engine
        assert launched == (7 * cfg.num_layers * (eng.num_prefills
                                                   + eng.num_decode_steps)
                            if device == "cuda" else 0)
        assert eng.adapter_pool.stats()["evictions"] > 0
        out[device] = session.serve([Request(**r.__dict__) for r in reqs])
    for r in reqs:
        assert out["cuda"][r.request_id].tokens == out["cpu"][r.request_id].tokens


@pytest.mark.parametrize("remat,policy", [("layer", None), ("attention", None),
                                          ("layer", "dots_saveable")])
def test_remat_gradients_are_bitwise_on_the_card(dev, remat, policy):
    """A small BERT with the fused slice's kernels (norms, bias+GeLU,
    softmax_dropout, cross-entropy) and dropout 0.1 on the card: the
    rematerialized step's loss and every gradient equal the step's
    without remat bit for bit (the recompute draws the same seed words),
    and the recompute launches the layers' forward kernels again. The
    embedding tables' gradients are held to f32 rounding instead: the
    CUDA embedding backward sums repeated tokens with atomics, so they
    differ from run to run without remat too."""
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import bert
    from tpudl_torch.rng import fold_in
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    rng = np.random.default_rng(0)
    mask = np.ones((8, 64), np.int32)
    mask[3, 40:] = 0
    batch = {"input_ids": rng.integers(0, 512, (8, 64)),
             "attention_mask": mask, "label": rng.integers(0, 2, 8)}
    params = None
    out = {}
    for r, p in ((False, None), (remat, policy)):
        cfg = bert.BERT_TINY(vocab_size=512, max_position_embeddings=64,
                             fused_ops=True, attention_impl="fused",
                             remat=r, remat_policy=p)
        model = bert.BertForSequenceClassification(cfg, device=dev)
        if params is None:
            model.init_weights(torch.Generator(device=dev).manual_seed(1))
            params = {k: v.detach().clone()
                      for k, v in model.state_dict().items()}
        state = create_train_state(0, model, make_optimizer(OptimConfig()),
                                   params=params, device=dev)
        step = make_classification_train_step(
            input_keys=("input_ids", "attention_mask"), loss_impl="auto")
        before = sd.softmax_dropout.launches
        out[r] = step.grads_and_metrics(state, batch, fold_in(3, 0, dev))
        launched = sd.softmax_dropout.launches - before
        assert launched == (2 if r else 1) * cfg.num_layers, launched
    (g0, m0), (g1, m1) = out[False], out[remat]
    assert torch.equal(m0["loss"], m1["loss"])
    for k in g0:
        if ".embeddings." in k and k.endswith("_embeddings.weight"):
            torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-7)
        else:
            assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# captured steps (tpudl_torch.graphs): CUDA-graph replays against the eager
# steps, bit for bit
# ---------------------------------------------------------------------------


def _launch_counts():
    from tpudl_torch.graphs import launch_counters

    return [getattr(f, a) for f, a in launch_counters()]


def _twin_train_states(dev, kind):
    """Two train states with the same weights, statistics and optimizer,
    the step and its batches: a BERT_TINY with the fused slice and dropout
    0.1 (AdamW with clipping and warmup), a ResNetTiny with BatchNorm
    (Nesterov SGD), or a LLAMA_TINY whose MLPs are 4-expert MoEs
    (``moe_aux_weight`` 0.01), each with ``accum_steps`` from ``kind``."""
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import bert
    from tpudl_torch.models.resnet import ResNetTiny
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    model_kind, accum = kind.split("-")
    rng = np.random.default_rng(4)
    if model_kind == "bert":
        def make():
            return bert.BertForSequenceClassification(bert.BERT_TINY(
                vocab_size=512, max_position_embeddings=64, fused_ops=True,
                attention_impl="fused", hidden_dropout=0.1,
                attention_dropout=0.1), device=dev)
        ocfg = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6,
                           grad_clip_norm=1.0, schedule="cosine")
        step = make_classification_train_step(
            input_keys=("input_ids", "attention_mask"), loss_impl="auto",
            accum_steps=int(accum))
        mask = np.ones((8, 64), np.int32)
        mask[3, 40:] = 0
        batches = [{"input_ids": rng.integers(0, 512, (8, 64)),
                    "attention_mask": mask, "label": rng.integers(0, 2, 8)}
                   for _ in range(4)]
    elif model_kind == "moe":
        from tpudl_torch.models import llama

        def make():
            return llama.LlamaForSequenceClassification(llama.LLAMA_TINY(
                moe_experts=4, max_seq_len=64), device=dev)
        ocfg = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6,
                           grad_clip_norm=1.0, schedule="cosine")
        step = make_classification_train_step(
            input_keys=("input_ids", "attention_mask"), loss_impl="auto",
            accum_steps=int(accum), moe_aux_weight=0.01)
        mask = np.ones((8, 32), np.int32)
        mask[3, 20:] = 0
        batches = [{"input_ids": rng.integers(0, 512, (8, 32)),
                    "attention_mask": mask, "label": rng.integers(0, 2, 8)}
                   for _ in range(4)]
    else:
        def make():
            return ResNetTiny(num_classes=10, dtype=torch.bfloat16,
                              device=dev)
        ocfg = OptimConfig(name="sgd", learning_rate=0.1, momentum=0.9,
                           weight_decay=1e-4, warmup_steps=1, total_steps=6,
                           schedule="cosine", grad_clip_norm=None)
        step = make_classification_train_step(
            0.1, loss_impl="auto", accum_steps=int(accum))
        batches = [{"image": rng.normal(size=(8, 16, 16, 3)).astype(
            np.float32), "label": rng.integers(0, 10, 8)} for _ in range(4)]
    model = make()
    model.init_weights(torch.Generator(device=dev).manual_seed(1))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    states = [create_train_state(0, make(), make_optimizer(ocfg),
                                 params=params, device=dev)
              for _ in range(2)]
    return states, step, batches


@pytest.mark.parametrize("kind", ["bert-1", "bert-2", "resnet-2", "moe-2"])
def test_captured_train_steps_equal_the_eager_steps_bitwise(dev, kind):
    """compile_step's first call runs eagerly, its second captures and
    replays, the rest replay: the losses of four steps, every parameter,
    the optimizer state and the BatchNorm statistics afterwards equal four
    eager steps' bit for bit (dropout on: a frozen mask would show on the
    second replay), and each replay adds the eager step's launch counts."""
    from tpudl_torch.train import compile_step

    (eager, captured), step, batches = _twin_train_states(dev, kind)
    compiled = compile_step(step, captured)
    per_step = []
    for i, batch in enumerate(batches):
        before = _launch_counts()
        eager, want = step(eager, batch, 5)
        torch.cuda.synchronize()
        mid = _launch_counts()
        captured, got = compiled(captured, batch, 5)
        torch.cuda.synchronize()
        after = _launch_counts()
        per_step.append(([m - b for m, b in zip(mid, before)],
                         [a - m for a, m in zip(after, mid)]))
        assert compiled.captured == (i >= 1)
        assert torch.equal(got["loss"], want["loss"]), i
        assert torch.equal(got["accuracy"], want["accuracy"]), i
        if "moe_aux" in want:
            assert torch.equal(got["moe_aux"], want["moe_aux"]), i
    for e, c in per_step:
        assert e == c and sum(e) > 0
    assert captured.step == eager.step == 4
    assert int(captured.opt_state["count"]) == 4
    mine = captured.model.state_dict()
    for name, t in eager.model.state_dict().items():
        assert torch.equal(mine[name], t), name
    if kind.startswith("resnet"):
        assert captured.batch_stats and all(
            torch.equal(v, eager.batch_stats[k])
            for k, v in captured.batch_stats.items())
    for key in ("mu", "nu", "trace"):
        for name, t in eager.opt_state.get(key, {}).items():
            assert torch.equal(captured.opt_state[key][name], t), (key, name)


def test_captured_step_refuses_a_new_shape_and_evaluate_replays_one_graph(dev):
    from tpudl_torch.train import (
        compile_step,
        evaluate,
        make_classification_eval_step,
    )

    (state, _), step, batches = _twin_train_states(dev, "bert-1")
    compiled = compile_step(step, state)
    for batch in batches[:2]:
        compiled(state, batch, 0)
    short = {k: v[:, :32] if v.ndim == 2 else v for k, v in batches[0].items()}
    with pytest.raises(ValueError, match=r"input_ids: \[8, 64\].*\[8, 32\]"):
        compiled(state, short, 0)
    eval_step = make_classification_eval_step(
        input_keys=("input_ids", "attention_mask"), loss_impl="auto")
    ceval = compile_step(eval_step, state, has_rng=False)
    tail = {k: v[:5] for k, v in batches[3].items()}
    data = batches + [tail]
    got = evaluate(ceval, state, data)
    want = evaluate(eval_step, state, data)
    assert ceval.captured and state.graph_pool is not None
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6 * max(1.0, abs(want[k])), k


def _bitwise_states(a, b):
    """Every parameter, statistic, optimizer tensor and count of two
    train states, bit for bit."""
    mine = b.model.state_dict()
    for name, t in a.model.state_dict().items():
        assert torch.equal(mine[name], t), name
    for key, value in a.opt_state.items():
        if isinstance(value, dict):
            for name, t in value.items():
                assert torch.equal(b.opt_state[key][name], t), (key, name)
    assert torch.equal(a.opt_state["count"], b.opt_state["count"])
    assert a.opt_state["host_count"] == b.opt_state["host_count"]
    assert a.step == b.step


@pytest.mark.parametrize("kind", ["bert-1", "resnet-2"])
def test_captured_run_resumed_from_a_checkpoint_equals_the_uninterrupted_run(
        dev, kind, tmp_path):
    """A captured BERT_TINY (fused slice, dropout 0.1) or ResNetTiny
    (BatchNorm, SGD traces) run checkpointed after 2 of 4 steps and
    resumed through resume_run into a state whose weights differ: a new
    compile_step captures again and the run ends bit for bit where the
    uninterrupted captured run ends, its losses those of the last 2
    steps."""
    from tpudl_torch.ft import (
        AsyncCheckpointManager,
        ResumableIterator,
        resume_run,
    )
    from tpudl_torch.train import compile_step, fit

    (control, head), step, batches = _twin_train_states(dev, kind)
    (fresh, _), _, _ = _twin_train_states(dev, kind)
    with torch.no_grad():
        for p in fresh.model.parameters():
            p.add_(1.0)
    want = []
    compiled = compile_step(step, control)
    for batch in batches:
        control, m = compiled(control, batch, 5)
        want.append(m["loss"])
    with AsyncCheckpointManager(str(tmp_path)) as mgr:
        fit(compile_step(step, head), head, ResumableIterator(batches), 5,
            num_steps=2, checkpoint_manager=mgr, checkpoint_every=2)
        state, rng, data, start = resume_run(mgr, fresh,
                                             ResumableIterator(batches))
        assert (state is fresh, rng, start) == (True, 5, 2)
        compiled = compile_step(step, state)
        got = []
        for batch in data:
            state, m = compiled(state, batch, rng)
            got.append(m["loss"])
    assert compiled.captured
    assert all(torch.equal(g, w) for g, w in zip(got, want[2:]))
    _bitwise_states(control, state)


def test_restore_into_a_captured_state_replays_correctly(dev, tmp_path):
    """compile_step's graph holds its state's tensors: a checkpoint of
    step 1 restored into the state after its step captured (the same
    tensors, the same storage) replays the remaining steps to the
    uninterrupted run's end, bit for bit."""
    from tpudl_torch.ft import AsyncCheckpointManager
    from tpudl_torch.train import compile_step

    (control, state), step, batches = _twin_train_states(dev, "bert-1")
    compiled = compile_step(step, control)
    for batch in batches:
        control, _ = compiled(control, batch, 5)
    compiled = compile_step(step, state)
    with AsyncCheckpointManager(str(tmp_path)) as mgr:
        state, _ = compiled(state, batches[0], 5)
        mgr.save(1, state, rng=5)
        for batch in batches[1:3]:
            state, _ = compiled(state, batch, 5)
        assert compiled.captured and state.step == 3
        ptrs = [p.data_ptr() for p in state.model.parameters()]
        mgr.wait_until_finished()
        assert mgr.restore(state) is state
    assert [p.data_ptr() for p in state.model.parameters()] == ptrs
    assert state.step == 1
    for batch in batches[1:]:
        state, _ = compiled(state, batch, 5)
    _bitwise_states(control, state)


@pytest.mark.parametrize("mode", ["dense", "paged", "adapters"])
def test_captured_decode_serves_the_eager_tokens(dev, mode):
    """LLAMA_TINY in f32 through the kernels, four slots: the session whose
    prefill and decode calls replay graphs (greedy selection in the graph,
    sampling eager) gives the eager session's tokens, greedy and sampled,
    and the same launch counts; a dense cache's device index follows its host
    mirror."""
    from tpudl_torch.graphs import CapturedCall
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params
    from tpudl_torch.serve import Request, ServeSession

    cfg = LLAMA_TINY(dtype=torch.float32, max_seq_len=64)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model = LlamaForCausalLM(cfg, device="meta")
    rng = np.random.default_rng(6)
    kw = {}
    tenants = [None]
    if mode == "paged":
        kw = dict(paged=True, page_size=4)
    elif mode == "adapters":
        shapes = {"attention.q_proj": (128, 128),
                  "attention.k_proj": (128, 64),
                  "attention.v_proj": (128, 64),
                  "attention.o_proj": (128, 128), "gate_proj": (128, 256),
                  "up_proj": (128, 256), "down_proj": (256, 128)}
        kw = dict(page_size=4, adapters={t: {f"model.layer_{i}.{site}": {
            "lora_a": rng.normal(0, 1 / r, (fi, r)).astype(np.float32),
            "lora_b": rng.normal(0, 0.05, (r, fo)).astype(np.float32)}
            for i in range(cfg.num_layers) for site, (fi, fo) in shapes.items()}
            for t, r in (("a", 4), ("b", 2))})
        tenants = [None, "a", "b"]
    reqs = [Request(f"r{i}", rng.integers(1, 512, size=int(
        rng.integers(2, 9))).tolist(), max_new_tokens=int(rng.integers(4, 12)),
        temperature=0.8 if i == 3 else 0.0, seed=i,
        tenant=tenants[i % len(tenants)]) for i in range(9)]
    out, counts = {}, {}
    for capture in (False, True):
        session = ServeSession.from_model(model, params, prompt_len=8,
                                          num_slots=4, capture=capture, **kw)
        call = session.engine.decode_call
        assert isinstance(call, CapturedCall) == capture
        prefill = session.engine.prefill_call
        assert isinstance(prefill, CapturedCall) == capture
        before = _launch_counts()
        out[capture] = session.serve([Request(**r.__dict__) for r in reqs])
        torch.cuda.synchronize()
        counts[capture] = [a - b for a, b in zip(_launch_counts(), before)]
        if capture:
            assert call.graph is not None and call.calls > 2
            assert prefill.graph is not None and prefill.calls > 2
        if mode == "dense":
            cache = session.engine.cache
            index = cache.cache["model"]["layer_0"]["attention"]["index"]
            assert int(index) == cache.write_index
    for r in reqs:
        assert out[True][r.request_id].tokens == out[False][r.request_id].tokens
    assert counts[True] == counts[False] and sum(counts[True]) > 0


def _tiny_llama(dev, **kw):
    from tpudl_torch.models.llama import LLAMA_TINY, LlamaForCausalLM, init_params

    cfg = LLAMA_TINY(dtype=torch.float32, max_seq_len=64, **kw)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return LlamaForCausalLM(cfg, device="meta"), params


@pytest.mark.parametrize("sampling", [
    {}, dict(temperature=0.8, top_k=50, top_p=0.9, eos_id=7)])
def test_captured_generate_chunks_equal_the_token_loop_bitwise(dev, sampling):
    """generate()'s decode chunks replay CUDA graphs (one per chunk length
    and switches; the first use of each eager): a ragged left-padded
    batch's tokens equal the per-token loop's bit for bit, greedy and
    sampled from the same generator, in a first call (warm-up and
    capture) and a second (replays), with the launch counts of the loop."""
    import importlib

    # The package re-exports the generate function under the module's name.
    gen = importlib.import_module("tpudl_torch.models.generate")
    model, params = _tiny_llama(dev)
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(1, 512, (3, 8)), device=dev)
    mask = torch.ones_like(ids)
    mask[1, :3] = 0
    kw = dict(max_new_tokens=20, eos_check_every=4, **sampling)
    for call in range(2):
        counts = []
        outs = []
        for chunked in (False, True):
            before = _launch_counts()
            outs.append(gen.generate(
                model, params, ids, mask, chunked=chunked,
                generator=torch.Generator(device=dev).manual_seed(3), **kw))
            torch.cuda.synchronize()
            counts.append([a - b for a, b in zip(_launch_counts(), before)])
        assert torch.equal(outs[0], outs[1]), call
        assert counts[0] == counts[1] and sum(counts[0]) > 0
    # Chunks of 4 over 19 decode steps: the chunk length and the
    # remainder, each captured on its second use (an early exit may
    # skip the remainder when sampling with an eos).
    assert gen.chunk_graphs(model) == 2 or (sampling and
                                            gen.chunk_graphs(model) == 1)


def test_captured_remat_step_equals_the_eager_remat_step_bitwise(dev):
    """compile_step on a BERT_TINY with remat="layer", the fused slice and
    dropout 0.1: the recomputes draw from twin generators registered with
    the capture, and four steps' losses, parameters and optimizer state
    equal the eager remat steps' bit for bit."""
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import bert
    from tpudl_torch.train import (
        compile_step,
        create_train_state,
        make_classification_train_step,
        make_optimizer,
    )

    def make():
        return bert.BertForSequenceClassification(bert.BERT_TINY(
            vocab_size=512, max_position_embeddings=64, fused_ops=True,
            attention_impl="fused", hidden_dropout=0.1,
            attention_dropout=0.1, remat="layer"), device=dev)

    model = make()
    model.init_weights(torch.Generator(device=dev).manual_seed(1))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ocfg = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6,
                       grad_clip_norm=1.0, schedule="cosine")
    eager, captured = (create_train_state(0, make(), make_optimizer(ocfg),
                                          params=params, device=dev)
                       for _ in range(2))
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), loss_impl="auto",
        accum_steps=2)
    rng = np.random.default_rng(4)
    compiled = compile_step(step, captured)
    for i in range(4):
        batch = {"input_ids": rng.integers(0, 512, (8, 64)),
                 "attention_mask": np.ones((8, 64), np.int32),
                 "label": rng.integers(0, 2, 8)}
        eager, want = step(eager, batch, 5)
        captured, got = compiled(captured, batch, 5)
        assert compiled.captured == (i >= 1)
        assert torch.equal(got["loss"], want["loss"]), i
    assert compiled.twins is not None and len(compiled.twins.twins) == 4
    mine = captured.model.state_dict()
    for name, t in eager.model.state_dict().items():
        assert torch.equal(mine[name], t), name


@pytest.mark.parametrize("paged", [False, True])
def test_artifact_sessions_serve_the_model_sessions_tokens(dev, paged):
    """Serving artifacts exported on the card (tpudl:: nodes for the norms
    and SwiGLU) and served through ServeSession.from_artifacts, prefill
    and decode captured: the model session's greedy tokens, with the
    artifact's shapes read back, and the kernels' counters moving; the
    exported prefill on the card against the same program on the CPU,
    strict."""
    from tpudl_torch.export import check_parity
    from tpudl_torch.export.decode import export_serving_decoder
    from tpudl_torch.export.export import load_exported_obj
    from tpudl_torch.graphs import CapturedCall
    from tpudl_torch.ops.library import graph_ops
    from tpudl_torch.ops.mlp_fused import swiglu
    from tpudl_torch.ops.norms import rms_norm
    from tpudl_torch.serve import Request, ServeSession

    model, params = _tiny_llama(dev)
    pre, dec = export_serving_decoder(model, params, 4, 8, paged=paged,
                                      page_size=4)
    ops = graph_ops(load_exported_obj(dec).graph_module)
    assert ops == {"rms_norm": 5, "swiglu": 2}, ops
    rng = np.random.default_rng(2)
    reqs = [Request(f"r{i}", rng.integers(1, 512, int(rng.integers(
        2, 9))).tolist(), max_new_tokens=10) for i in range(7)]
    kw = dict(paged=True, page_size=4) if paged else {}
    want = ServeSession.from_model(model, params, prompt_len=8, num_slots=4,
                                   **kw).serve(
        [Request(**r.__dict__) for r in reqs])
    session = ServeSession.from_artifacts(pre, dec, params, paged=paged)
    assert isinstance(session.engine.decode_call, CapturedCall)
    assert (session.num_slots, session.prompt_len,
            session.max_seq_len) == (4, 8, 64)
    before = (rms_norm.launches, swiglu.launches)
    got = session.serve([Request(**r.__dict__) for r in reqs])
    assert rms_norm.launches > before[0] and swiglu.launches > before[1]
    for r in reqs:
        assert got[r.request_id].tokens == want[r.request_id].tokens
    ids = torch.as_tensor(rng.integers(1, 512, (1, 8)), dtype=torch.int32)
    report = check_parity(pre, (params, ids, torch.ones_like(ids)))
    assert report.ok, str(report)


# ---------------------------------------------------------------------------
# fp8 training: torch._scaled_mm against the plain version, the captured
# policy step with a skipped step, the fused loss at a loss scale
# ---------------------------------------------------------------------------


def _fp8_rings(dev, *amaxes, window=16):
    from tpudl_torch.ops.fp8_dot import amax_history_init, update_amax_history

    out = []
    for a in amaxes:
        out.append(update_amax_history(amax_history_init(window, dev),
                                       torch.tensor(a, device=dev)))
    return out


@pytest.mark.parametrize("m,k,n", [(64, 32, 48), (256, 768, 768),
                                   (512, 768, 3072), (512, 3072, 768)])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_fp8_dot_matches_plain_on_the_card(dev, m, k, n, w_dtype):
    """``torch._scaled_mm`` (e4m3 x e4m3 forward, e5m2 x e4m3 dx, e5m2 x
    e4m3 dw) against the plain version on the same fp8 values and scales:
    both sum in f32 (``use_fast_accum=False``) and round once to the
    output dtype, so they part by the sums' order and that one rounding:
    at most 2^-7 of the output's largest magnitude (bf16's step); the
    gradient amax is exact."""
    from tpudl_torch.ops.fp8_dot import fp8_dot

    rng = np.random.default_rng(m + k + n)
    x0 = _t(rng, (2, m // 2, k), torch.bfloat16, dev)
    w0 = (_t(rng, (n, k), torch.float32, dev) * 0.05).to(w_dtype)
    g = _t(rng, (2, m // 2, n), torch.bfloat16, dev) * 0.01
    hx, hw, hg = _fp8_rings(dev, float(x0.float().abs().max()) * 0.9,
                            float(w0.float().abs().max()), 0.02)
    outs = {}
    for impl in ("auto", "reference"):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        g_amax = torch.zeros((), device=dev)
        out = fp8_dot(x, w, hx, hw, hg, g_amax, impl=impl)
        out.backward(g)
        outs[impl] = (out.detach(), x.grad, w.grad, g_amax)
    for name, got, want in zip(("out", "dx", "dw"), outs["auto"][:3],
                               outs["reference"][:3]):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0**-7 * float(want.float().abs().max()), (name, err)
    assert torch.equal(outs["auto"][3], outs["reference"][3])


def test_fp8_dot_refuses_shapes_scaled_mm_does_not_take(dev):
    """A dimension that is not a multiple of 16 raises, naming the shape;
    nothing falls back to the plain version."""
    from tpudl_torch.ops.fp8_dot import fp8_dot

    hx, hw, hg = _fp8_rings(dev, 1.0, 1.0, 1.0)
    x = torch.ones(8, 32, device=dev, dtype=torch.bfloat16)
    w = torch.ones(48, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"M=8, K=32, N=48"):
        fp8_dot(x, w, hx, hw, hg)
    with pytest.raises(ValueError, match="multiples of 16"):
        fp8_dot(torch.ones(16, 40, device=dev, dtype=torch.bfloat16),
                torch.ones(48, 40, device=dev, dtype=torch.bfloat16),
                hx, hw, hg)


def _fp8_states(dev):
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import bert
    from tpudl_torch.train import (
        create_train_state,
        make_classification_train_step,
        make_optimizer,
        policy,
    )

    cfg = policy("fp8").configure_model(bert.BERT_TINY(
        vocab_size=512, max_position_embeddings=64, fused_ops=True,
        attention_impl="fused", hidden_dropout=0.1, attention_dropout=0.1,
        fp8_train=True))
    model = bert.BertForSequenceClassification(cfg, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(1))
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ocfg = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=8)
    states = [create_train_state(
        0, bert.BertForSequenceClassification(cfg, device=dev),
        make_optimizer(ocfg), params=params, device=dev, precision="fp8")
        for _ in range(2)]
    step = make_classification_train_step(
        input_keys=("input_ids", "attention_mask"), loss_impl="auto",
        precision="fp8")
    rng = np.random.default_rng(6)
    batches = [{"input_ids": rng.integers(0, 512, (16, 64)),
                "attention_mask": np.ones((16, 64), np.int32),
                "label": rng.integers(0, 2, 16)} for _ in range(5)]
    return states, step, batches


def test_captured_fp8_step_with_a_skip_equals_the_eager_steps(dev):
    """BERT_TINY with fp8 sites (``torch._scaled_mm``) under the fp8
    policy, eager against compile_step: five steps, the fourth with the
    position table poisoned (a nonfinite gradient: skipped, the table put
    back after). Losses, ``grad_skipped``, every parameter, optimizer
    tensor, ring and loss-scale leaf equal bit for bit; the skipped step
    moved no host count, eager or replayed; each replay adds the eager
    step's launches (the three ``_scaled_mm`` counters included)."""
    from tpudl_torch.ops.fp8_dot import fp8_dot
    from tpudl_torch.train import compile_step

    (eager, captured), step, batches = _fp8_states(dev)
    compiled = compile_step(step, captured, precision="fp8")
    name = "bert.embeddings.position_embeddings.weight"
    for i, batch in enumerate(batches):
        olds = []
        if i == 3:
            for st in (eager, captured):
                p = dict(st.model.named_parameters())[name]
                olds.append(p.detach().clone())
                with torch.no_grad():
                    p[0, 0] = float("inf")
        before = _launch_counts()
        eager, want = step(eager, batch, 3)
        torch.cuda.synchronize()
        mid = _launch_counts()
        captured, got = compiled(captured, batch, 3)
        torch.cuda.synchronize()
        after = _launch_counts()
        assert [m - b for m, b in zip(mid, before)] == \
            [a - m for a, m in zip(after, mid)]
        assert fp8_dot.launches_fwd > 0 and fp8_dot.launches_dw > 0
        for k in ("loss", "grad_skipped", "loss_scale"):
            # The poisoned step's loss is NaN in both.
            assert torch.equal(got[k], want[k]) or (
                got[k].isnan() and want[k].isnan()), (i, k)
        assert float(got["grad_skipped"]) == (1.0 if i == 3 else 0.0)
        for st, old in zip((eager, captured), olds):
            with torch.no_grad():
                dict(st.model.named_parameters())[name].copy_(old)
    assert captured.step == eager.step == 4
    assert captured.opt_state["host_count"] == 4
    assert int(captured.opt_state["count"]) == 4
    _bitwise_states(eager, captured)
    from tpudl_torch.ft.manager import flatten_with_keys

    a = dict(flatten_with_keys(eager.precision))
    b = dict(flatten_with_keys(captured.precision))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert float(eager.precision["loss_scale"]["scale"]) == 2.0**14
    assert int(eager.precision["loss_scale"]["skipped"]) == 1


def test_cross_entropy_backward_at_loss_scale(dev):
    """The fused loss's backward kernel receives the scaled upstream
    gradient: at scale 2^15 it stays finite and is the unscaled gradient
    times the scale, bit for bit (a power of two), as its plain version."""
    rng = np.random.default_rng(9)
    logits = _t(rng, (256, 30522), torch.bfloat16, dev) * 4
    labels = torch.from_numpy(rng.integers(0, 30522, 256)).to(dev)
    grads = []
    for scale in (1.0, 2.0**15):
        x = logits.clone().requires_grad_()
        (softmax_cross_entropy(x, labels, impl="fused").mean() * scale
         ).backward()
        grads.append(x.grad)
    assert bool(torch.isfinite(grads[1]).all())
    assert torch.equal(grads[1], grads[0] * 2.0**15)


# ---------------------------------------------------------------------------
# the weight-only quantized product (csrc/quant_dot.cu)
# ---------------------------------------------------------------------------

# Kernel vs plain twin (rtol, share of the output's largest magnitude):
# both sum exact f32 products in f32 in another order and round once; f32
# x through the tensor cores (three bf16 terms, M > 16) keeps ~f32.
QUANT_TOL = {torch.bfloat16: (2.0**-7, 2.0**-10), torch.float32: (1e-5, 1e-4)}


def _quant_case(dev, m, k, n, dtype, wd, seed=0):
    from tpudl_torch.quant.quantize import quantize_leaf

    rng = np.random.default_rng(seed)
    w = _t(rng, (n, k), torch.float32, dev) * 0.05
    leaf = quantize_leaf(w, wd)
    return _t(rng, (m, k), dtype, dev), leaf["qvalues"], leaf["qscale"]


def _assert_quant_close(y, ref, dtype):
    rtol, share = QUANT_TOL[dtype]
    atol = share * float(ref.float().abs().max())
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 128])
@pytest.mark.parametrize("k,n", [(256, 192), (4096, 1024), (100, 70),
                                 (1000, 200), (520, 64 * 3 + 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wd", ["int8", "fp8_e4m3"])
def test_quant_dot_kernel_matches_plain(dev, m, k, n, dtype, wd):
    """The GEMV (M <= 16) and the tiled product (M > 16) against the plain
    twin: K a multiple of 16 and not (100, 1000 and 520 take the scalar
    or ragged paths), N not a multiple of the 64-wide tile; two runs
    bitwise equal."""
    from tpudl_torch.ops import quant_dot as qd

    x, q, s = _quant_case(dev, m, k, n, dtype, wd, seed=m + k + n)
    y = qd._quant_dot_cuda(x, q, s)
    again = qd._quant_dot_cuda(x, q, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (m, n)
    _assert_quant_close(y, qd.quant_matmul_ref(x, q, s), dtype)
    assert torch.equal(y, again)


# The TMA + wgmma product (bf16 x in whole 16-byte vectors, M > 16), on
# the plan of tpudl_torch.ops.quant_dot.gemm_plan: M across one and several
# 128-row tiles (17, 128, 129, 4099), N and K off the 128-channel and
# 64-deep tiles (1000, 4112), shapes that split K (M 17 to 129 against
# K 4112) and that do not (M 4099, and K 256); int8 and e4m3; two runs bit
# for bit.
@pytest.mark.parametrize("m", [17, 128, 129, 4099])
@pytest.mark.parametrize("k,n", [(256, 192), (4112, 1000), (768, 3072)])
@pytest.mark.parametrize("wd", ["int8", "fp8_e4m3"])
def test_quant_dot_tma_route_matches_plain_and_repeats(dev, m, k, n, wd):
    from tpudl_torch.ops import quant_dot as qd

    x, q, s = _quant_case(dev, m, k, n, torch.bfloat16, wd, seed=m * k + n)
    plan = qd.gemm_plan(m, n, k)
    if (m, k) == (17, 4112) or (m, k) == (128, 4112):
        assert plan["split"] > 1
    if m == 4099 or k == 256:
        assert plan["split"] == 1
    y = qd._quant_dot_cuda(x, q, s)
    again = qd._quant_dot_cuda(x, q, s)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    _assert_quant_close(y, qd.quant_matmul_ref(x, q, s), torch.bfloat16)
    assert torch.equal(y, again)


# The tensor-core GEMV (bf16 x in whole 16-byte vectors, M <= 16), on the
# plan of tpudl_torch.ops.quant_dot.gemv_plan: M across one and two n8
# tiles of x; tiles of 16 channels (K 1024 -> N 4096) and of 8 (N <= 1056),
# ragged N and K (1000, 4112), 4 rounds of K a warp (14336 -> 256).
GEMV_SHAPES = [(1024, 4096), (4096, 1024), (4112, 1000), (256, 192),
               (14336, 256)]


@pytest.mark.parametrize("m", [1, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("wd", ["int8", "fp8_e4m3"])
def test_quant_gemv_tensor_core_route_matches_plain_and_replays(dev, m, k, n,
                                                                wd):
    """Against the plain twin at QUANT_TOL; two runs bit for bit; a graph
    replay equal to the eager call."""
    from tpudl_torch.ops import quant_dot as qd

    x, q, s = _quant_case(dev, m, k, n, torch.bfloat16, wd, seed=m * k + n)
    assert qd.vector_route(x, q)
    plan = qd.gemv_plan(m, n, k)
    if (k, n) == (14336, 256):
        assert plan["rounds"] > 1
    y = qd._quant_dot_cuda(x, q, s)
    again = qd._quant_dot_cuda(x, q, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qd._quant_dot_cuda(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = qd._quant_dot_cuda(x, q, s)
    graph.replay()
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    _assert_quant_close(y, qd.quant_matmul_ref(x, q, s), torch.bfloat16)
    assert torch.equal(y, again) and torch.equal(y, replayed)


def _every_weight(wd, n, k):
    """[n, k] weights whose every column holds each storable value: int8
    -128..127 (and so +-127 and -128); e4m3 every bit pattern but the two
    NaNs (+-448, the smallest subnormal 2^-9, -0)."""
    codes = (np.arange(n)[:, None] + np.arange(k)[None, :]) % 256
    if wd == "int8":
        return torch.from_numpy(codes.astype(np.uint8).view(np.int8))
    codes[(codes & 0x7F) == 0x7F] = 0x7E  # NaN -> 448 (or -448)
    return torch.from_numpy(codes.astype(np.uint8)).view(torch.float8_e4m3fn)


@pytest.mark.parametrize("wd", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_quant_gemv_widens_every_weight_exactly(dev, wd, m):
    """One-hot rows of x pick single weights: each output is a weight
    widened exactly (every int8 and e4m3 value is a bf16), equal bit for
    bit to the plain twin."""
    from tpudl_torch.ops import quant_dot as qd

    n, k = 256, 256
    q = _every_weight(wd, n, k).to(dev)
    s = torch.ones(n, device=dev)
    x = torch.zeros(m, k, device=dev, dtype=torch.bfloat16)
    cols = [(37 * i + 5) % k for i in range(m)]
    x[torch.arange(m), cols] = 1.0
    y = qd._quant_dot_cuda(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(y, q[:, cols].t().float().to(torch.bfloat16))
    assert torch.equal(y, qd.quant_matmul_ref(x, q, s))
    if wd == "fp8_e4m3":
        assert float(y.float().abs().max()) == 448.0
        assert float(y.float().abs()[y != 0].min()) == 2.0**-9


def test_quant_gemv_dependent_launch_reads_what_the_kernel_before_wrote(dev):
    """RMSNorm writes x and the GEMV reads it straight after, 6 rounds
    (each round's x the last GEMV's output, [4, 4096] -> 4096 int8):
    synchronized after every launch, back to back (the GEMV a dependent
    launch that may start while the norm runs, and asks L2 for its
    weights before griddepcontrol.wait) and replayed from a CUDA graph,
    all equal bit for bit."""
    from tpudl_torch.ops import quant_dot as qd

    x0, q, s = _quant_case(dev, 4, 4096, 4096, torch.bfloat16, "int8", seed=5)
    scale = 1 + 0.1 * _t(np.random.default_rng(6), (4096,), torch.float32, dev)

    def chain(x, sync):
        out = []
        for _ in range(6):
            h = rms_norm(x, scale, impl="fused")
            sync()
            x = qd._quant_dot_cuda(h, q, s)
            sync()
            out += [h, x]
        return out

    serial = chain(x0, torch.cuda.synchronize)
    eager = chain(x0, lambda: None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(x0, lambda: None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = chain(x0, lambda: None)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(serial, eager, replayed):
        assert torch.equal(a, b) and torch.equal(a, c)
    _assert_quant_close(serial[-1], qd.quant_matmul_ref(serial[-2], q, s),
                        torch.bfloat16)


@pytest.mark.parametrize("m", [4, 128])
def test_quant_dot_replays_in_a_graph_equal_to_eager(dev, m):
    from tpudl_torch.ops import quant_dot as qd

    x, q, s = _quant_case(dev, m, 4096, 1024, torch.bfloat16, "int8")
    eager = qd._quant_dot_cuda(x, q, s)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qd._quant_dot_cuda(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qd._quant_dot_cuda(x, q, s)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_quant_dot_refuses_what_the_kernel_does_not_take(dev):
    from tpudl_torch.ops import quant_dot as qd
    from tpudl_torch.quant.dense import quant_dot

    x, q, s = _quant_case(dev, 4, 64, 32, torch.bfloat16, "int8")
    with pytest.raises(ValueError, match="K = x's last dimension"):
        qd._quant_dot_cuda(x[:, :48], q, s)
    with pytest.raises(ValueError, match="f32 or bf16 x"):
        qd._quant_dot_cuda(x.half(), q, s)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        qd._quant_dot_cuda(x, q.to(torch.int16), s)
    with pytest.raises(ValueError, match="qscale must be"):
        qd._quant_dot_cuda(x, q, s[:5])
    with pytest.raises(ValueError, match="contiguous"):
        qd._quant_dot_cuda(x[:, :32], q[:, ::2], s)
    with pytest.raises(ValueError, match="expected"):
        qd._quant_dot_cuda(x, q.cpu(), s)
    # "fused" and "auto" on the card launch the kernel; nothing falls back.
    leaf = {"qvalues": q, "qscale": s}
    with pytest.raises(ValueError, match="K = x's last dimension"):
        quant_dot(x[:, :48], leaf, impl="fused")


def test_quant_dot_counts_launches_and_never_runs_the_plain_twin(
        dev, monkeypatch):
    from tpudl_torch.ops import quant_dot as qd
    from tpudl_torch.quant.dense import quant_dot

    def refuse(*args):
        raise AssertionError("the plain twin ran on a CUDA tensor")

    monkeypatch.setattr(qd, "quant_matmul_ref", refuse)
    x, q, s = _quant_case(dev, 4, 256, 64, torch.bfloat16, "fp8_e4m3")
    before = qd.quant_matmul.launches
    for impl in ("auto", "fused"):
        quant_dot(x, {"qvalues": q, "qscale": s}, impl=impl)
    quant_dot(torch.cat([x] * 8), {"qvalues": q, "qscale": s})
    torch.cuda.synchronize()
    assert qd.quant_matmul.launches == before + 3


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "int8_kv8"])
def test_captured_quantized_decode_serves_the_eager_tokens(dev, mode):
    """LLAMA_TINY f32 quantized (and over int8 KV pages): the captured
    session gives the eager session's tokens and launch counts, 14
    quant_dot launches a prefill or decode step."""
    from tpudl_torch.ops.quant_dot import quant_matmul
    from tpudl_torch.serve import Request, ServeSession

    model, params = _tiny_llama(dev)
    kw = dict(weight_dtype="fp8_e4m3" if mode == "fp8_e4m3" else "int8")
    if mode == "int8_kv8":
        kw.update(paged=True, page_size=4, kv_dtype="int8")
    rng = np.random.default_rng(8)
    reqs = [Request(f"r{i}", rng.integers(1, 512, size=int(
        rng.integers(2, 9))).tolist(), max_new_tokens=int(rng.integers(4, 12)))
        for i in range(6)]
    out, counts = {}, {}
    for capture in (False, True):
        session = ServeSession.from_model(model, params, prompt_len=8,
                                          num_slots=4, capture=capture, **kw)
        quant_matmul.launches = 0
        out[capture] = session.serve([Request(**r.__dict__) for r in reqs])
        torch.cuda.synchronize()
        eng = session.engine
        counts[capture] = quant_matmul.launches
        assert counts[capture] == 14 * (eng.num_prefills + eng.num_decode_steps)
    for r in reqs:
        assert out[True][r.request_id].tokens == out[False][r.request_id].tokens
    assert counts[True] == counts[False]
