"""tpudl_torch.ops.norms against tpudl.ops.norms on the CPU.

The same inputs (numpy, from a seed) go through the port's ``rms_norm``
— on a CPU tensor, its plain version — and through tpudl's, both as the
XLA composite (``impl="reference"``) and as the Pallas kernel in
interpret mode (``impl="fused", interpret=True``, as
tests/test_fused_norms.py runs it off-TPU). Tolerances are tpudl's own:
f32 rtol/atol 1e-5, bf16 0.05 (the Pallas kernel adds the residual in
f32, the composites in bf16). The Hopper kernel itself is held against
the plain version on the card by tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops import norms as jnorms
from tpudl_torch.ops import norms

TOL = {"float32": 1e-5, "bfloat16": 0.05}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(h, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 3, h)).astype(np.float32)
    r = rng.normal(size=(2, 3, h)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(h,))).astype(np.float32)
    as_jax = [jnp.asarray(x, JAX_DTYPE[dtype]), jnp.asarray(r, JAX_DTYPE[dtype]),
              jnp.asarray(scale)]
    as_torch = [torch.from_numpy(x).to(TORCH_DTYPE[dtype]),
                torch.from_numpy(r).to(TORCH_DTYPE[dtype]),
                torch.from_numpy(scale)]
    return as_jax, as_torch


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [96, 128, 4096])
@pytest.mark.parametrize("mode", ["plain", "residual", "residual_nosum"])
def test_rms_norm_matches_tpudl(reference, dtype, h, mode):
    (jx, jr, jscale), (tx, tr, tscale) = _inputs(h, dtype, seed=h)
    kw = (dict(impl="reference") if reference == "composite"
          else dict(impl="fused", interpret=True))
    use_res = mode != "plain"
    return_sum = mode != "residual_nosum"
    want = jnorms.rms_norm(jx, jscale, jr if use_res else None, eps=1e-5,
                           return_sum=return_sum, **kw)
    got = norms.rms_norm(tx, tscale, tr if use_res else None, eps=1e-5,
                         return_sum=return_sum)
    if mode == "residual":
        assert isinstance(got, tuple) and len(got) == 2
        pairs = zip(got, want)
    else:
        assert isinstance(got, torch.Tensor)
        pairs = [(got, want)]
    for g, w in pairs:
        assert g.dtype == TORCH_DTYPE[dtype] and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_fused_on_a_cpu_tensor_raises():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        norms.rms_norm(x, torch.ones(8), impl="fused")


@pytest.mark.parametrize("impl", ["pallas", "", "Fused"])
def test_unknown_impl_raises(impl):
    with pytest.raises(ValueError, match="impl must be"):
        norms.rms_norm(torch.ones(2, 8), torch.ones(8), impl=impl)


def test_cpu_calls_never_count_as_launches():
    before = norms.rms_norm.launches
    x = torch.ones(4, 16)
    for impl in ("auto", "reference"):
        norms.rms_norm(x, torch.ones(16), impl=impl)
        norms.rms_norm(x, torch.ones(16), x, impl=impl)
    assert norms.rms_norm.launches == before


@pytest.mark.parametrize("flag", [False, True, "force"])
def test_fused_ops_flag_maps_like_tpudl(flag):
    assert norms.fused_ops_impl(flag) == jnorms.fused_ops_impl(flag)


def test_resolve_impl_dispatches_by_device():
    cpu = torch.device("cpu")
    assert norms.resolve_impl("auto", cpu) is False
    assert norms.resolve_impl("reference", cpu) is False
    assert norms.resolve_impl("auto", torch.device("cuda", 0)) is True
    assert norms.resolve_impl("fused", torch.device("cuda", 0)) is True
    with pytest.raises(ValueError):
        norms.resolve_impl("auto", torch.device("meta"))


def _ln_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    h = shape[-1]
    arrs = [(2 * rng.normal(size=shape) + 0.5).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            (1 + 0.1 * rng.normal(size=(h,))).astype(np.float32),
            (0.1 * rng.normal(size=(h,))).astype(np.float32)]
    as_jax = [jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrs[:2]] + [
        jnp.asarray(a) for a in arrs[2:]]
    as_torch = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs[:2]] + [
        torch.from_numpy(a) for a in arrs[2:]]
    return as_jax, as_torch


@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h", [96, 768])
@pytest.mark.parametrize("mode", ["plain", "residual", "residual_nosum"])
def test_layer_norm_matches_tpudl(reference, dtype, h, mode):
    (jx, jr, js, jb), (tx, tr, ts, tb) = _ln_inputs((2, 3, h), dtype, seed=h)
    kw = (dict(impl="reference") if reference == "composite"
          else dict(impl="fused", interpret=True))
    use_res = mode != "plain"
    return_sum = mode != "residual_nosum"
    want = jnorms.layer_norm(jx, js, jb, jr if use_res else None, eps=1e-12,
                             return_sum=return_sum, **kw)
    got = norms.layer_norm(tx, ts, tb, tr if use_res else None, eps=1e-12,
                           return_sum=return_sum)
    pairs = zip(got, want) if mode == "residual" else [(got, want)]
    for g, w in pairs:
        assert g.dtype == TORCH_DTYPE[dtype] and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("residual,with_gs", [(False, False), (True, False),
                                              (True, True)])
def test_norm_bwd_ref_matches_vjp_of_tpudl_kernel(kind, residual, with_gs):
    """The plain backward against jax.vjp of tpudl's Pallas forward in
    interpret mode (whose backward is _norm_bwd_kernel), f32, 1e-4."""
    import jax

    (jx, jr, js, jb), (tx, tr, ts, tb) = _ln_inputs((4, 5, 128), "float32", 7)
    rng = np.random.default_rng(8)
    gy = rng.normal(size=(4, 5, 128)).astype(np.float32)
    gsum = rng.normal(size=(4, 5, 128)).astype(np.float32)
    eps = 1e-6

    def f(x, scale, bias, r):
        kw = dict(eps=eps, return_sum=with_gs, impl="fused", interpret=True)
        res = r if residual else None
        if kind == "layer":
            return jnorms.layer_norm(x, scale, bias, res, **kw)
        return jnorms.rms_norm(x, scale, res, **kw)

    out, vjp = jax.vjp(f, jx, js, jb, jr)
    cot = (jnp.asarray(gy), jnp.asarray(gsum)) if with_gs else jnp.asarray(gy)
    jdx, jdscale, jdbias, jdr = vjp(cot)

    r = tr if residual else None
    mean, rstd = norms.norm_stats_ref(tx, r, kind=kind, eps=eps)
    dx, dscale, dbias = norms.norm_bwd_ref(
        tx, ts, r, mean, rstd, torch.from_numpy(gy),
        torch.from_numpy(gsum) if with_gs else None, kind=kind)
    np.testing.assert_allclose(_np(dx), _np(jdx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(dscale), _np(jdscale), rtol=1e-4, atol=1e-4)
    if kind == "layer":
        np.testing.assert_allclose(_np(dbias), _np(jdbias), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert dbias is None
    if residual:
        np.testing.assert_allclose(_np(dx), _np(jdr), rtol=1e-4, atol=1e-4)


def test_norm_backward_dispatch_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    s = torch.ones(32)
    g = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    mean, rstd = norms.norm_stats_ref(x, kind="layer", eps=1e-6)
    before = norms.norm_bwd.launches
    got = norms.norm_bwd(x, s, None, mean, rstd, g, kind="layer")
    want = norms.norm_bwd_ref(x, s, None, mean, rstd, g, kind="layer")
    assert norms.norm_bwd.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        norms.norm_bwd(x, s, None, mean, rstd, g, kind="layer", impl="fused")
    with pytest.raises(ValueError, match="kind must be"):
        norms.norm_bwd(x, s, None, mean, rstd, g, kind="group")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        norms.layer_norm(x, s, s, impl="fused")


# The backward kernel's launch plan (tpudl_torch.ops.norms.bwd_plan): which
# route, how many blocks, how many rows a warp or block. The kernel sums
# its dscale / dbias partials in an order fixed by the plan, so the plan
# must cover every row exactly once and depend on the shape alone.
BWD_PLAN_SHAPES = [
    (n, h, itemsize, aligned)
    for n in (1, 37, 1056, 1057, 3001, 8192, 32768)
    for h, itemsize in ((768, 2), (1024, 2), (768, 4), (1024, 4), (4096, 2),
                        (2048, 2), (4096, 4), (766, 2), (100, 4))
    for aligned in (True, False)
]


def _bwd_row_ranges(plan, n):
    """The rows each unit of ``plan`` walks, as csrc/norms.cu assigns
    them: ``(block, unit within the block, first row, end)`` per warp
    (rows route) or block, in launch order, empty units included."""
    per_block = plan["rows_per_block"] // plan["rows"]
    out = []
    for b in range(plan["parts"]):
        for w in range(per_block):
            first = (b * per_block + w) * plan["rows"]
            out.append((b, w, min(first, n), min(first + plan["rows"], n)))
    return out


@pytest.mark.parametrize("n,h,itemsize,aligned", BWD_PLAN_SHAPES)
def test_bwd_plan_covers_every_row_once(n, h, itemsize, aligned):
    plan = norms.bwd_plan(n, h, itemsize, aligned)
    vector = aligned and (h * itemsize) % 16 == 0
    if not vector:
        assert plan["route"] == "scalar"
    elif (h <= norms.BWD_ROWS_MAX_H
          and h * itemsize <= 16 * norms.BWD_ROWS_MAX_VECTORS):
        assert plan["route"] == "rows"
        assert plan["parts"] <= 2 * 132
    else:
        assert plan["route"] == "wide"
        assert plan["parts"] <= 3 * 132
    ranges = _bwd_row_ranges(plan, n)
    covered = [r for _, _, first, end in ranges for r in range(first, end)]
    assert covered == list(range(n))
    # Units are contiguous stripes in launch order, and the last block
    # has rows (the kernel refuses a plan whose last block is empty).
    last_block = [first < end for b, _, first, end in ranges
                  if b == plan["parts"] - 1]
    assert any(last_block)
    per_block = plan["rows_per_block"] // plan["rows"]
    assert len(ranges) == plan["parts"] * per_block
    # The block covers the row: threads (lanes, on the rows route) times
    # vectors (values, unaligned) a thread reach every column, with one of
    # the vector counts the kernels are built for.
    threads, vpl = plan["threads"], plan["vpl"]
    assert threads % 32 == 0
    units = h if plan["route"] == "scalar" else h * itemsize // 16
    if plan["route"] == "rows":
        assert threads == 32 * norms.BWD_ROW_WARPS
        assert vpl in ((1, 2, 3, 4, 6) if itemsize == 4 else (1, 2, 3, 4))
        assert 32 * vpl >= units > 32 * (vpl - 1 - (vpl == 6))
    else:
        cap = (norms.BWD_WIDE_THREADS if plan["route"] == "wide"
               else norms.BWD_SCALAR_THREADS)
        assert vpl in (1, 2, 4, 8) and threads <= cap
        assert threads * vpl >= units > (threads - 32) * vpl
        # The fewest vectors a thread that the block's threads allow.
        assert vpl == 1 or -(-units // (vpl // 2)) > cap


def test_bwd_plan_sizes_match_the_kernel_source():
    """bwd_plan's sizes are the ones csrc/norms.cu was compiled with."""
    from tests.csrc_helpers import csrc_constants

    c = csrc_constants("norms")
    assert norms.BWD_ROW_WARPS == c["kBwdRowWarps"]
    assert norms.BWD_ROWS_MAX_H == c["kBwdRowsMaxH"]
    assert norms.BWD_WIDE_THREADS == c["kBwdWideThreads"]
    assert norms.BWD_SCALAR_THREADS == c["kBwdScalarThreads"]


@pytest.mark.parametrize("h,itemsize,aligned", [(16392, 2, True),
                                                (8200, 4, True),
                                                (4104, 2, False)])
def test_bwd_plan_refuses_rows_too_wide(h, itemsize, aligned):
    with pytest.raises(ValueError, match="norm_bwd kernel takes rows"):
        norms.bwd_plan(64, h, itemsize, aligned)
    norms.bwd_plan(64, h - 8 - 8 * (not aligned), itemsize, aligned)


@pytest.mark.parametrize("n,h", [(8192, 1024), (32768, 768), (8192, 4096)])
def test_bwd_plan_depends_on_the_shape_alone(n, h):
    """The same shape always gets the same plan (so the same partial-sum
    order and the same bits); BERT's and Llama's calls take the routes
    their widths were designed for."""
    plans = [norms.bwd_plan(n, h, 2, True) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0]["route"] == ("wide" if h > 1024 else "rows")
    assert norms.bwd_plan(n, h, 2, False)["route"] == "scalar"
