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
