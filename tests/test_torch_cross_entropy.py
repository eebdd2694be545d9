"""tpudl_torch.ops.cross_entropy against tpudl on the CPU.

The same logits and labels, made with numpy from a seed, go through
tpudl's fused ``softmax_cross_entropy`` (its Pallas kernels in interpret
mode, as tests/test_fused_cross_entropy.py runs them; V pads to a
multiple of 128 there) and through the port's plain version
(``impl="auto"`` on CPU tensors). Tolerances are tpudl's: forward rtol
1e-5 / atol 1e-5, gradients rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops.cross_entropy import softmax_cross_entropy as jxent
from tpudl_torch.ops import cross_entropy as xent
from tpudl_torch.train.loop import cross_entropy_loss


def _data(seed, lead, v, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=lead + (v,)) * scale).astype(np.float32)
    labels = rng.integers(0, v, size=lead).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("v", [2, 1000, 1003])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("lead", [(19,), (3, 5)])
def test_forward_and_gradient_match_tpudl(v, smoothing, lead):
    logits, labels = _data(v + len(lead), lead, v)
    w = np.random.default_rng(1).uniform(0.0, 2.0, size=lead).astype(np.float32)
    jz, jl = jnp.asarray(logits), jnp.asarray(labels)
    want = jxent(jz, jl, smoothing, impl="fused")
    want_g = jax.grad(lambda z: jnp.sum(
        jxent(z, jl, smoothing, impl="fused") * jnp.asarray(w)))(jz)
    z = torch.from_numpy(logits).requires_grad_(True)
    got = xent.softmax_cross_entropy(z, torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32 and tuple(got.shape) == lead
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_plain_backward_is_the_closed_form(smoothing):
    """xent_bwd_ref (the backward kernel's plain version: g * (softmax -
    q) from the saved logsumexp) is the gradient autograd finds through
    the plain forward."""
    logits, labels = _data(3, (11,), 300)
    g = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 2.0, size=11).astype(np.float32))
    z = torch.from_numpy(logits).requires_grad_(True)
    lab = torch.from_numpy(labels)
    (xent.softmax_cross_entropy_ref(z, lab, smoothing) * g).sum().backward()
    lse = torch.logsumexp(z.detach(), -1)
    got = xent.xent_bwd(z.detach(), lab, lse, g, smoothing)
    np.testing.assert_allclose(got.numpy(), z.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    # bf16 logits: dz comes back in the logits' dtype.
    assert xent.xent_bwd(z.detach().bfloat16(), lab, lse, g,
                         smoothing).dtype == torch.bfloat16


def test_dispatch_rules_and_shape_checks():
    logits, labels = _data(5, (4,), 10)
    z, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    before = (xent.softmax_cross_entropy.launches, xent.xent_bwd.launches)
    auto = xent.softmax_cross_entropy(z, lab)
    ref = xent.softmax_cross_entropy(z, lab, impl="reference")
    assert torch.equal(auto, ref)
    assert (xent.softmax_cross_entropy.launches,
            xent.xent_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        xent.softmax_cross_entropy(z, lab, impl="fused")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        xent.xent_bwd(z, lab, torch.zeros(4), torch.ones(4), impl="fused")
    with pytest.raises(ValueError, match=r"logits \[\.\.\., V\]"):
        xent.softmax_cross_entropy(z, lab[:3])
    with pytest.raises(ValueError, match=r"logits \[\.\.\., V\]"):
        xent.softmax_cross_entropy(z[0], lab[0])


def test_train_loss_routes_through_the_op():
    """cross_entropy_loss(impl=...) is the mean of softmax_cross_entropy:
    the reference composite, unchanged, and "auto" on the CPU is the same
    plain version."""
    logits, labels = _data(6, (8,), 5)
    z, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    for s in (0.0, 0.1):
        want = xent.softmax_cross_entropy_ref(z, lab, s).mean()
        assert torch.equal(cross_entropy_loss(z, lab, s), want)
        assert torch.equal(cross_entropy_loss(z, lab, s, impl="auto"), want)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cross_entropy_loss(z, lab, impl="fused")
