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

from tpudl_torch.ops.mlp_fused import swiglu, swiglu_ref
from tpudl_torch.ops.norms import rms_norm, rms_norm_ref

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [96, 100, 4096, 4104])
@pytest.mark.parametrize("mode", ["plain", "residual", "residual_nosum"])
def test_rms_norm_kernel_matches_plain(dev, dtype, h, mode):
    rng = np.random.default_rng(h)
    x = _t(rng, (2, 5, h), dtype, dev)
    r = _t(rng, (2, 5, h), dtype, dev) if mode != "plain" else None
    scale = _t(rng, (h,), torch.float32, dev)
    before = rms_norm.launches
    out = rms_norm(x, scale, r, eps=1e-5, return_sum=mode != "residual_nosum",
                   impl="fused")
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    ref = rms_norm_ref(x, scale, r, eps=1e-5)
    if mode == "residual":
        (y, s), (yr, sr) = out, ref
        # The sum is x + r rounded once, in both.
        torch.testing.assert_close(s.float(), sr.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    else:
        y, yr = out, ref if mode == "plain" else ref[0]
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(), yr.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 14336), (3, 77), (1, 5)])
def test_swiglu_kernel_matches_plain(dev, dtype, shape):
    rng = np.random.default_rng(shape[1])
    g = _t(rng, shape, dtype, dev) * 4
    u = _t(rng, shape, dtype, dev)
    before = swiglu.launches
    y = swiglu(g, u, impl="fused")
    torch.cuda.synchronize()
    assert swiglu.launches == before + 1
    assert y.dtype == dtype and y.shape == g.shape
    torch.testing.assert_close(y.float(), swiglu_ref(g, u).float(),
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
