"""tpudl_torch.ops.softmax_dropout and the dropout contract against tpudl
on the CPU.

The same inputs, made with numpy from a seed, go through tpudl's
``softmax_dropout`` / ``hybrid_attention`` (its Pallas kernels in
interpret mode, as tests/test_fused_attention.py runs them) and through
the port's plain versions (``impl="auto"`` on CPU tensors). Tolerances
are tpudl's: the f32 softmax 1e-6, attention 2e-4, attention gradients
5e-4. Interpret mode has no TPU PRNG, so with dropout on the port's plain
path is checked alone, by keep rate and expectation; its Philox is the
function the kernels compute (the card tests hold them bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops import attention as jattention
from tpudl.ops.softmax_dropout import hybrid_attention as jhybrid
from tpudl.ops.softmax_dropout import softmax_dropout as jsoftmax_dropout
from tpudl_torch.ops import attention, keep_mask, softmax_dropout as sd

#: Random123's known-answer vectors for Philox4x32-10 (counter, key, out).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_ints(c, k):
    """Philox4x32-10 in Python integers (an independent spelling)."""
    m = 0xFFFFFFFF
    c, (k0, k1) = list(c), k
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & m, (k1 + 0xBB67AE85) & m
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & m, (p0 >> 32) ^ c[3] ^ k1, p0 & m]
    return tuple(c)


def _i64(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = keep_mask.philox4x32_10(*map(_i64, counter), *map(_i64, key))
    assert tuple(int(w) for w in got) == want
    assert _philox_ints(counter, key) == want


def test_philox_twin_matches_python_integers():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(64, 6), dtype=np.uint64)
    cols = [torch.from_numpy(words[:, j].astype(np.int64)) for j in range(6)]
    got = torch.stack(keep_mask.philox4x32_10(*cols[:4], cols[4], cols[5]), 1)
    for row, out in zip(words.tolist(), got.tolist()):
        assert tuple(out) == _philox_ints(row[:4], row[4:])


def test_keep_mask_is_a_pure_function_of_flat_index():
    """Element i's bits are word i % 4 of the block at counter i // 4, so
    the mask of a shape is the flat mask reshaped, whatever the shape."""
    seed = torch.tensor([123456789, 4000000000], dtype=torch.int64)
    bits = keep_mask.philox_bits(seed, 1003)
    for i in (0, 1, 2, 3, 4, 517, 1002):
        block = _philox_ints((i // 4, 0, 0, 0), (123456789, 4000000000))
        assert int(bits[i]) == block[i % 4]
    thr = keep_mask.threshold(0.1)
    assert thr == round(0.1 * 2**32)
    m4 = keep_mask.keep_mask(seed, (2, 3, 7, 11), 0.1)
    m1 = keep_mask.keep_mask(seed, (462,), 0.1)
    assert torch.equal(m4.reshape(-1), m1)
    assert torch.equal(m1, bits[:462] >= thr)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        keep_mask.threshold(1.0)


def test_seed_words_come_from_the_generator():
    g = torch.Generator().manual_seed(5)
    a = keep_mask.draw_seed(g)
    assert a.dtype == torch.int64 and a.shape == (2,)
    assert bool(((a >= 0) & (a < 2**32)).all())
    assert torch.equal(a, keep_mask.draw_seed(torch.Generator().manual_seed(5)))
    assert not torch.equal(a, keep_mask.draw_seed(g))
    # At rate 0 a call draws nothing from the generator.
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    x = torch.zeros(1, 1, 4, 8)
    sd.softmax_dropout(x, dropout_rate=0.0, dropout_rng=g1)
    assert torch.equal(g1.get_state(), g2.get_state())


def _logits(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _padding(seed, b, s):
    lengths = np.random.default_rng(seed).integers(s // 2, s + 1, size=b)
    return (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)


def test_softmax_matches_tpudl_no_mask():
    x = _logits(5, (2, 4, 64, 96), 4.0)
    want = jsoftmax_dropout(jnp.asarray(x), out_dtype=jnp.float32)
    got = sd.softmax_dropout(torch.from_numpy(x), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("mask_form", ["2d", "4d"])
@pytest.mark.parametrize("causal", [False, True])
def test_softmax_masks_and_pads_match_tpudl(mask_form, causal):
    """Skv = 72 is not a multiple of 128 (tpudl pads it, the port need
    not); padding with or without the causal triangle; a fully padded
    row is 0."""
    s = 72
    x = _logits(6, (2, 2, s, s))
    am = _padding(7, 2, s)
    am[1, :] = 0
    jmask = jnp.asarray(am)
    tmask = torch.from_numpy(am)
    if mask_form == "4d":
        jmask, tmask = jmask[:, None, None, :], tmask[:, None, None, :]
    want = jsoftmax_dropout(jnp.asarray(x), mask=jmask, causal=causal,
                               out_dtype=jnp.float32)
    got = sd.softmax_dropout(torch.from_numpy(x), mask=tmask, causal=causal,
                             out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[1].abs().max()) == 0.0


def test_softmax_bf16_output_matches_tpudl():
    x = _logits(8, (2, 3, 16, 40), 3.0)
    want = jsoftmax_dropout(jnp.asarray(x, jnp.bfloat16))
    got = sd.softmax_dropout(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0**-8, atol=1e-6)


def test_softmax_grad_matches_tpudl():
    x = _logits(8, (2, 2, 64, 64))
    am = _padding(9, 2, 64)

    def f_j(z):
        return jnp.sum(jsoftmax_dropout(z, mask=jnp.asarray(am),
                                           out_dtype=jnp.float32) ** 2)

    want = jax.grad(f_j)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (sd.softmax_dropout(xt, mask=torch.from_numpy(am),
                        out_dtype=torch.float32) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_is_autograd_through_plain_forward(rate, causal):
    """softmax_dropout_bwd_ref (the backward kernel's plain version, which
    recomputes p and regenerates the mask) is the gradient of
    softmax_dropout_ref with the same seed words."""
    x = torch.from_numpy(_logits(10, (2, 3, 40, 40), 2.0))
    g = torch.from_numpy(_logits(11, (2, 3, 40, 40)))
    kvmask = torch.from_numpy(_padding(12, 2, 40)).bool()
    seed = torch.tensor([7, 2**32 - 9], dtype=torch.int64)
    xl = x.clone().requires_grad_(True)
    out = sd.softmax_dropout_ref(xl, kvmask, seed, causal, rate, torch.float32)
    (out * g).sum().backward()
    dx = sd.softmax_dropout_bwd(x, kvmask, seed, g, causal, rate)
    np.testing.assert_allclose(dx.numpy(), xl.grad.numpy(), atol=1e-6)
    # Dropped entries of the forward are exactly 0, and the backward's
    # mask is the forward's: g' = 0 there, so dx = -p * <g', p>.
    if rate:
        keep = keep_mask.keep_mask(seed, x.shape, rate)
        assert bool((out.detach()[~keep] == 0).all())


def _qkv(seed, b=2, s=96, h=4, d=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_hybrid_attention_matches_tpudl_no_mask():
    q, k, v = _qkv(0)
    want = jhybrid(*_j(q, k, v))
    got = sd.hybrid_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_hybrid_attention_matches_tpudl_padding_and_causal():
    q, k, v = _qkv(1)
    am = _padding(2, 2, 96)
    want = jhybrid(*_j(q, k, v), mask=jnp.asarray(am),
                                causal=True)
    got = sd.hybrid_attention(*_t(q, k, v), mask=torch.from_numpy(am),
                              causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_hybrid_attention_grads_match_tpudl():
    q, k, v = _qkv(3)
    am = _padding(4, 2, 96)

    def loss_j(q, k, v):
        return jnp.sum(jhybrid(q, k, v, mask=jnp.asarray(am)) ** 2)

    want = jax.grad(loss_j, (0, 1, 2))(*_j(q, k, v))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    (sd.hybrid_attention(*leaves, mask=torch.from_numpy(am)) ** 2).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-4)


def test_attend_fused_dispatch_and_refusals():
    q, k, v = _qkv(9, s=64)
    want = jattention.attend(*_j(q, k, v), implementation="fused")
    got = attention.attend(*_t(q, k, v), implementation="fused")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(
        got.numpy(), attention.attend(*_t(q, k, v)).numpy(), atol=2e-4)
    # At 256 < S <= 512 "fused" is the whole-row attention
    # (tests/test_torch_fused_attention.py).
    from tpudl_torch.ops.fused_attention import fused_attention

    big = torch.randn(1, 384, 2, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(attention.attend(big, big, big, implementation="fused"),
                       fused_attention(big, big, big))
    # Past S = 512 "fused" is flash attention (tests/test_torch_flash_attention.py).
    big = torch.zeros(1, 640, 2, 32)
    assert torch.equal(attention.attend(big, big, big, implementation="fused"),
                       big)
    qt, kt, vt = _t(q, k, v)
    with pytest.raises(ValueError, match="dropout_exact"):
        attention.attend(qt, kt, vt, implementation="fused", dropout_rate=0.1,
                         dropout_rng=torch.Generator(), dropout_exact=True)
    dense = torch.ones(2, 4, 64, 64, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="dense mask"):
        attention.attend(qt, kt, vt, dense, implementation="fused")


def test_softmax_dropout_refusals():
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sd.softmax_dropout(x, impl="fused")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sd.hybrid_attention(*_t(*_qkv(0, s=8)), impl="fused")
    with pytest.raises(ValueError, match="Sq == Skv"):
        sd.softmax_dropout(torch.zeros(1, 2, 4, 8), causal=True)
    with pytest.raises(ValueError, match="dropout_rng"):
        sd.softmax_dropout(x, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        sd.softmax_dropout(x, dropout_rate=1.0, dropout_rng=torch.Generator())
    with pytest.raises(NotImplementedError, match="dense mask"):
        sd.softmax_dropout(x, mask=torch.ones(1, 2, 8, 8, dtype=torch.bool))
    before = (sd.softmax_dropout.launches, sd.softmax_dropout_bwd.launches)
    sd.softmax_dropout(x.requires_grad_(True)).sum().backward()
    assert (sd.softmax_dropout.launches,
            sd.softmax_dropout_bwd.launches) == before


def test_softmax_dropout_long_rows_name_the_attention_routes():
    """Rows past the kernel's width are refused before any device check,
    and the refusal names the routes that take them."""
    skv = sd.MAX_SKV + 88
    with pytest.raises(ValueError, match=rf'Skv={skv}: longer rows go to '
                       r'flash_attention, or to attend\("fused"\)'):
        sd._check(torch.zeros(1, 2, 4, skv), None, keep_mask.zero_seed("cpu"),
                  "softmax_dropout")


def test_normalize_kv_mask_matches_tpudl():
    am = _padding(3, 3, 10)
    for mask in (None, am, am[:, None, None, :], am[:1]):
        want = jattention.normalize_kv_mask(
            None if mask is None else jnp.asarray(mask), 3, 10)
        got = attention.normalize_kv_mask(
            None if mask is None else torch.from_numpy(mask), 3, 10,
            device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dropout_keep_rate_and_expectation():
    """The plain path with dropout on, zero logits (p = 1/Skv): over 2 M
    elements the keep share is within 5 sigma of 0.9, each kept value is
    p / 0.9, and the output's mean is within 5 sigma of p."""
    rate, s = 0.1, 128
    x = torch.zeros(8, 16, s, s)
    out = sd.softmax_dropout(x, dropout_rate=rate,
                             dropout_rng=torch.Generator().manual_seed(3),
                             out_dtype=torch.float32)
    n = out.numel()
    kept = out != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / n)
    p = np.float32(1.0 / s)
    assert set(torch.unique(out).tolist()) == {
        0.0, float(p * np.float32(1.0 / (1.0 - rate)))}
    mean_sigma = p * np.sqrt(rate / (1 - rate) / n)
    assert abs(out.mean().item() - p) < 5 * mean_sigma
    # Same generator seed, same mask; another seed, another mask.
    again = sd.softmax_dropout(x, dropout_rate=rate,
                               dropout_rng=torch.Generator().manual_seed(3),
                               out_dtype=torch.float32)
    other = sd.softmax_dropout(x, dropout_rate=rate,
                               dropout_rng=torch.Generator().manual_seed(4),
                               out_dtype=torch.float32)
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_hybrid_attention_dropout_expectation():
    """Attention dropout on the plain path keeps E[output] == the
    undropped attention: the mean over 64 seeds is within 5 standard
    errors of it, entry by entry on average."""
    q, k, v = _t(*_qkv(13, b=1, s=32, h=2, d=8))
    want = sd.hybrid_attention(q, k, v)
    outs = torch.stack([
        sd.hybrid_attention(q, k, v, dropout_rate=0.1,
                            dropout_rng=torch.Generator().manual_seed(i))
        for i in range(64)])
    err = (outs.mean(0) - want).abs() / (outs.std(0) / 8 + 1e-12)
    assert float(err.mean()) < 5.0
