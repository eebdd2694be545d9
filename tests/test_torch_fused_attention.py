"""tpudl_torch.ops.fused_attention against tpudl.ops.fused_attention on the
CPU.

The same inputs, made with numpy from a seed, go through tpudl's
``fused_attention`` (its Pallas kernels in interpret mode, as
tests/test_fused_attention.py runs them) and through the port's plain
versions (``impl="auto"`` on CPU tensors, through the same autograd
Function the kernels use), at 256 < S <= 512, where ``attend("fused")``
reaches them. Tolerances are tpudl's (tests/test_fused_attention.py:37,
51, 69): the forward atol 2e-4, the gradients atol 5e-4. tpudl's kernel
draws dropout only on a TPU, so with dropout on the port is held by
distribution (keep rate, expectation) and against ``hybrid_attention``
on the same seed words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops.fused_attention import fused_attention as jfused
from tpudl_torch.ops import attention, keep_mask
from tpudl_torch.ops import flash_attention as fa
from tpudl_torch.ops import fused_attention as fu
from tpudl_torch.ops.softmax_dropout import hybrid_attention


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b=2, s=300, h=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _padding(seed, b, s):
    lengths = np.random.default_rng(seed).integers(s // 2, s + 1, size=b)
    return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("s,masking,causal", [
    (300, "none", False),
    (300, "padding", True),
    (384, "padding", False),
    (384, "none", True),
])
def test_forward_matches_tpudl(s, masking, causal, one_thread):
    q, k, v = _qkv(s, s=s)
    am = _padding(s + 1, 2, s) if masking == "padding" else None
    want = jfused(*(jnp.asarray(a) for a in (q, k, v)),
                  mask=None if am is None else jnp.asarray(am), causal=causal)
    got = fu.fused_attention(*_t(q, k, v),
                             mask=None if am is None else torch.from_numpy(am),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("s,causal", [(300, True), (384, False)])
def test_grads_match_tpudl(s, causal, one_thread):
    import jax

    q, k, v = _qkv(s + 2, s=s)
    am = _padding(s + 3, 2, s)
    go = np.random.default_rng(s + 4).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jfused(q, k, v, mask=jnp.asarray(am), causal=causal)
        return jnp.sum(o * jnp.asarray(go))

    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o = fu.fused_attention(*leaves, mask=torch.from_numpy(am), causal=causal)
    (o * torch.from_numpy(go)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-4)


@pytest.mark.parametrize("s,lengths,causal", [
    (300, (100, 300), False),
    (384, (128, 250), True),
])
def test_dead_kv_blocks_get_zero_dk_dv_like_tpudl(s, lengths, causal,
                                                  one_thread):
    """A 128-row kv block that the padding mask leaves dead gets dK = dV
    = 0 exactly, in tpudl's backward and in the port's (the dK/dV kernel
    writes zeros there and runs no product), and the gradients agree."""
    import jax

    q, k, v = _qkv(s + 7, s=s)
    am = (np.arange(s)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    go = np.random.default_rng(s + 8).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jfused(q, k, v, mask=jnp.asarray(am), causal=causal)
        return jnp.sum(o * jnp.asarray(go))

    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o = fu.fused_attention(*leaves, mask=torch.from_numpy(am), causal=causal)
    (o * torch.from_numpy(go)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-4)
    dead = -(-lengths[0] // 128) * 128  # the first kv block past the length
    assert dead < s
    for grad in (leaves[1].grad, leaves[2].grad, *want[1:]):
        assert not np.asarray(grad)[0, dead:].any()
    assert leaves[1].grad[1].abs().amax() > 0


def test_fully_masked_rows_give_zero_like_tpudl(one_thread):
    """A batch row whose kv mask is all zeros keeps nothing: o = 0 there,
    as the TPU kernel's re-zeroing gives (the reference softmax would
    spread it uniformly)."""
    q, k, v = _qkv(40, s=260)
    am = _padding(41, 2, 260)
    am[1] = 0
    want = jfused(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(am))
    got = fu.fused_attention(*_t(q, k, v), mask=torch.from_numpy(am))
    assert not got[1].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_is_autograd_through_plain_forward(rate):
    """fused_attention_bwd_ref (the backward kernels' plain version, from
    the row statistic lse, with delta = rowsum(dp * p)) is the gradient
    of fused_attention_ref with the same seed words."""
    q, k, v = _t(*_qkv(42, s=40))
    kvmask = torch.from_numpy(_padding(43, 2, 40)).bool()
    seed = torch.tensor([5, 2**32 - 3], dtype=torch.int64)
    go = torch.from_numpy(np.random.default_rng(44).normal(
        size=q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fu.fused_attention_ref(*leaves, kvmask, seed, True, None, rate)
    (o * go).sum().backward()
    got = fu.fused_attention_bwd(q, k, v, kvmask, seed, go, lse.detach(),
                                 True, None, rate)
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5)


def test_dropout_keep_rate_and_expectation(one_thread):
    """By distribution, as tpudl's TPU-only dropout allows: the keep mask
    of a [2, 2, 300, 300] call keeps 0.9 of the entries within 5 sigma,
    and the mean of the dropped output over 200 seeds is the undropped
    output (tpudl's) within 6 standard errors per element."""
    rate, n = 0.1, 200
    q, k, v = _qkv(45, b=1, s=300, h=1, d=8)
    want = np.array(jfused(*(jnp.asarray(a) for a in (q, k, v))))
    gen = torch.Generator().manual_seed(46)
    draws = torch.stack([
        fu.fused_attention(*_t(q, k, v), dropout_rate=rate, dropout_rng=gen)
        for _ in range(n)]).double()
    mean, se = draws.mean(0), draws.std(0) / n ** 0.5
    assert bool(((mean - torch.from_numpy(want).double()).abs()
                 <= 6 * se + 1e-5).all())
    seed = keep_mask.draw_seed(torch.Generator().manual_seed(47))
    kept = keep_mask.keep_mask(seed, (2, 2, 300, 300), rate)
    sigma = (rate * (1 - rate) / kept.numel()) ** 0.5
    assert abs(kept.double().mean().item() - (1 - rate)) < 5 * sigma


def test_dropout_matches_a_composite_and_hybrid_attention(one_thread):
    """The keep mask is keep_mask's at the flat [B, H, S, S] index: the
    dropped output equals a composite that applies it after the softmax,
    and at S = 128 it equals hybrid_attention's (and its gradients) on
    the same seed words."""
    rate = 0.1
    q, k, v = _t(*_qkv(48, s=300))
    am = torch.from_numpy(_padding(49, 2, 300))
    got = fu.fused_attention(q, k, v, am, causal=True, dropout_rate=rate,
                             dropout_rng=torch.Generator().manual_seed(3))
    seed = keep_mask.draw_seed(torch.Generator().manual_seed(3))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    keep = am.bool()[:, None, None, :] & torch.ones(300, 300).tril().bool()
    p = torch.softmax(torch.where(keep, s, attention.MASK_VALUE), -1)
    p = torch.where(keep_mask.keep_mask(seed, p.shape, rate),
                    p / (1.0 - rate), 0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    q, k, v = _t(*_qkv(50, s=128))
    am = torch.from_numpy(_padding(51, 2, 128))
    outs = []
    for fn in (fu.fused_attention, hybrid_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, am, causal=True, dropout_rate=rate,
               dropout_rng=torch.Generator().manual_seed(21))
        (o * o).sum().backward()
        outs.append([o] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_validation_errors():
    z = torch.zeros(1, 300, 2, 16)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fu.fused_attention(z[:, :290], z, z)
    big = torch.zeros(1, 520, 2, 16)
    with pytest.raises(ValueError, match="S=520 > 512"):
        fu.fused_attention(big, big, big)
    with pytest.raises(NotImplementedError, match="dense mask"):
        fu.fused_attention(z, z, z, torch.ones(1, 2, 300, 300, dtype=torch.bool))
    with pytest.raises(ValueError, match="head_group 3 does not divide 2"):
        fu.fused_attention(z, z, z, head_group=3)
    assert torch.equal(fu.fused_attention(z, z, z, head_group=2), z)
    with pytest.raises(ValueError, match="dropout_rng"):
        fu.fused_attention(z, z, z, dropout_rate=0.1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fu.fused_attention(z, z, z, impl="fused")


def test_attend_fused_dispatch_by_sequence_length(one_thread):
    """attend("fused") reaches hybrid_attention at S = 128, the
    whole-row kernels' plain versions at S = 384 (where tpudl sends it to
    fused_attention), and flash at S = 640; at 384 it matches tpudl's
    attend("fused")."""
    from tpudl.ops import attention as jattention

    for s, fn in ((128, hybrid_attention), (384, fu.fused_attention),
                  (640, fa.flash_attention)):
        q, k, v = _t(*_qkv(60 + s, b=1, s=s, h=1))
        am = torch.from_numpy(_padding(61 + s, 1, s))
        got = attention.attend(q, k, v, am, implementation="fused",
                               causal=True)
        assert torch.equal(got, fn(q, k, v, am, causal=True)), s
    q, k, v = _t(*_qkv(62, b=1, s=384, h=1))
    am = _padding(63, 1, 384)
    want = jattention.attend(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             mask=jnp.asarray(am), implementation="fused")
    got = attention.attend(q, k, v, torch.from_numpy(am),
                           implementation="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_counters_do_not_move_on_the_cpu():
    q, k, v = (t.requires_grad_(True) for t in _t(*_qkv(70, s=264)))
    before = (fu.fused_attention_fwd.launches, fu.fused_attention_bwd.launches)
    fu.fused_attention(q, k, v, causal=True).sum().backward()
    assert (fu.fused_attention_fwd.launches,
            fu.fused_attention_bwd.launches) == before
    # At rate 0 a call draws nothing from the generator.
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    fu.fused_attention(q, k, v, dropout_rng=g1)
    assert torch.equal(g1.get_state(), g2.get_state())
