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
