"""tpudl_torch.ops.mlp_fused against tpudl.ops.mlp_fused on the CPU.

The same inputs go through the port's ``swiglu`` (its plain version, on
a CPU tensor) and through tpudl's ``swiglu_ref`` and its Pallas kernel
in interpret mode. Tolerances: f32 1e-5; bf16 0.05 (the Pallas kernel
computes in f32 and rounds once, the composites round at each op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops import mlp_fused as jmlp
from tpudl_torch.ops import mlp_fused

TOL = {"float32": 1e-5, "bfloat16": 0.05}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 14336), (2, 3, 256), (5, 77)])
def test_swiglu_matches_tpudl(reference, dtype, shape):
    rng = np.random.default_rng(shape[-1])
    gate = (3 * rng.normal(size=shape)).astype(np.float32)
    up = rng.normal(size=shape).astype(np.float32)
    jg, ju = (jnp.asarray(a, JAX_DTYPE[dtype]) for a in (gate, up))
    tg, tu = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (gate, up))
    if reference == "composite":
        want = jmlp.swiglu_ref(jg, ju)
    else:
        want = jmlp.swiglu(jg, ju, impl="fused", interpret=True)
    got = mlp_fused.swiglu(tg, tu)
    assert got.dtype == TORCH_DTYPE[dtype] and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_swiglu_dispatch_rules():
    g = torch.ones(3, 8)
    before = mlp_fused.swiglu.launches
    mlp_fused.swiglu(g, g)
    mlp_fused.swiglu(g, g, impl="reference")
    assert mlp_fused.swiglu.launches == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mlp_fused.swiglu(g, g, impl="fused")
    with pytest.raises(ValueError, match="impl must be"):
        mlp_fused.swiglu(g, g, impl="triton")


BG_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (0.05, 0.02)}


@pytest.mark.parametrize("reference", ["composite", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 3072), (2, 3, 128), (5, 77)])
def test_bias_gelu_matches_tpudl(reference, dtype, shape):
    rng = np.random.default_rng(shape[-1])
    x = (2 * rng.normal(size=shape)).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    jx = jnp.asarray(x, JAX_DTYPE[dtype])
    tx = torch.from_numpy(x).to(TORCH_DTYPE[dtype])
    if reference == "composite":
        want = jmlp.bias_gelu_ref(jx, jnp.asarray(b))
    else:
        want = jmlp.bias_gelu(jx, jnp.asarray(b), impl="fused", interpret=True)
    got = mlp_fused.bias_gelu(tx, torch.from_numpy(b))
    assert got.dtype == TORCH_DTYPE[dtype] and tuple(got.shape) == shape
    rtol, atol = BG_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_bwd_ref_matches_vjp_of_tpudl_kernel(dtype):
    """The plain backward against jax.vjp of tpudl's Pallas bias_gelu in
    interpret mode (whose backward is _bg_bwd_kernel): f32 1e-4; bf16
    dx in tpudl's band, db (an f32 sum in both) 1e-4 relative."""
    import jax

    rng = np.random.default_rng(3)
    x = (2 * rng.normal(size=(24, 256))).astype(np.float32)
    b = rng.normal(size=(256,)).astype(np.float32)
    g = rng.normal(size=(24, 256)).astype(np.float32)
    jx = jnp.asarray(x, JAX_DTYPE[dtype])
    _, vjp = jax.vjp(
        lambda x_, b_: jmlp.bias_gelu(x_, b_, impl="fused", interpret=True),
        jx, jnp.asarray(b))
    jdx, jdb = vjp(jnp.asarray(g, JAX_DTYPE[dtype]))
    dx, db = mlp_fused.bias_gelu_bwd_ref(
        torch.from_numpy(x).to(TORCH_DTYPE[dtype]), torch.from_numpy(b),
        torch.from_numpy(g).to(TORCH_DTYPE[dtype]))
    assert dx.dtype == TORCH_DTYPE[dtype] and db.dtype == torch.float32
    tol = (1e-4, 1e-4) if dtype == "float32" else BG_TOL[dtype]
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx, np.float32),
                               rtol=tol[0], atol=tol[1])
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb, np.float32),
                               rtol=1e-4, atol=1e-4)


def test_bias_gelu_dispatch_rules():
    x = torch.ones(3, 8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    before = (mlp_fused.bias_gelu.launches, mlp_fused.bias_gelu_bwd.launches)
    mlp_fused.bias_gelu(x, b).sum().backward()
    mlp_fused.bias_gelu_bwd(x.detach(), b.detach(), torch.ones(3, 8))
    assert (mlp_fused.bias_gelu.launches,
            mlp_fused.bias_gelu_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mlp_fused.bias_gelu(x, b, impl="fused")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mlp_fused.bias_gelu_bwd(x, b, x, impl="fused")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(24, 256), (5, 77)])
def test_swiglu_bwd_ref_matches_vjp_of_tpudl_kernel(dtype, shape):
    """The SwiGLU backward's plain version against jax.vjp of tpudl's
    Pallas swiglu in interpret mode (whose backward is _sw_bwd_kernel):
    f32 1e-5; bf16 0.05 (both compute in f32 and round once; the bf16
    band covers a one-step rounding difference)."""
    import jax

    rng = np.random.default_rng(shape[-1] + 1)
    gate = (3 * rng.normal(size=shape)).astype(np.float32)
    up = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jg, ju, jgo = (jnp.asarray(a, JAX_DTYPE[dtype]) for a in (gate, up, g))
    _, vjp = jax.vjp(lambda a, b: jmlp.swiglu(a, b, impl="fused",
                                              interpret=True), jg, ju)
    want = vjp(jgo)
    tg, tu, tgo = (torch.from_numpy(a).to(TORCH_DTYPE[dtype])
                   for a in (gate, up, g))
    got = mlp_fused.swiglu_bwd_ref(tg, tu, tgo)
    for t, w in zip(got, want):
        assert t.dtype == TORCH_DTYPE[dtype] and tuple(t.shape) == shape
        np.testing.assert_allclose(t.float().numpy(), np.asarray(w, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    # On CPU tensors swiglu_bwd is its plain version.
    for a, b in zip(mlp_fused.swiglu_bwd(tg, tu, tgo), got):
        assert torch.equal(a, b)


def test_swiglu_bwd_dispatch_rules():
    g = torch.ones(3, 8, requires_grad=True)
    u = torch.ones(3, 8, requires_grad=True)
    before = (mlp_fused.swiglu.launches, mlp_fused.swiglu_bwd.launches)
    mlp_fused.swiglu(g, u).sum().backward()
    mlp_fused.swiglu_bwd(g.detach(), u.detach(), torch.ones(3, 8))
    assert (mlp_fused.swiglu.launches, mlp_fused.swiglu_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mlp_fused.swiglu_bwd(g, u, g, impl="fused")
