"""tpudl_torch.ops.flash_attention against tpudl.ops.flash_attention on the
CPU.

The same inputs, made with numpy from a seed, go through tpudl's
``flash_attention`` / ``flash_attention_with_lse`` (its Pallas kernels in
interpret mode, as tests/test_flash_attention.py runs them) and through
the port's plain versions (``impl="auto"`` on CPU tensors, through the
same autograd Function the kernels use). Tolerances are tpudl's
(tests/test_flash_attention.py:38-149): the forward rtol 1e-5 / atol
1e-4 in f32 and 0.05 / 0.02 in bf16, gradients 1e-4. tpudl's flash draws
dropout only on a TPU, so with dropout on the port is held against a
composite attention that applies ``ops/keep_mask.py``'s mask, and
against ``hybrid_attention`` on the same seed words. Shapes stay within
one 128 tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops import attention as jattention
from tpudl.ops.flash_attention import flash_attention as jflash
from tpudl.ops.flash_attention import flash_attention_with_lse as jflash_lse
from tpudl_torch.ops import attention, keep_mask
from tpudl_torch.ops import flash_attention as fa
from tpudl_torch.ops.softmax_dropout import hybrid_attention

JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-4),
           "bfloat16": dict(rtol=0.05, atol=0.02)}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b=2, sq=64, skv=64, h=2, d=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, h, d)).astype(np.float32))


def _padding(seed, b, skv):
    lengths = np.random.default_rng(seed).integers(skv // 2, skv + 1, size=b)
    return (np.arange(skv)[None, :] < lengths[:, None]).astype(np.int32)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


#: name -> (sq, skv, masking, causal, dtype)
CASES = {
    "no_mask": (64, 64, None, False, "float32"),
    "padding_mask": (64, 64, "2d", False, "float32"),
    "padding_mask_4d": (64, 64, "4d", False, "float32"),
    "causal": (128, 128, None, True, "float32"),
    "causal_padding": (64, 64, "2d", True, "float32"),
    "causal_sq_ne_skv": (48, 80, None, True, "float32"),
    "causal_sq_gt_skv": (80, 48, None, True, "float32"),
    "unaligned_50_70": (50, 70, "2d", False, "float32"),
    "bf16": (64, 64, "2d", True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_tpudl(case, one_thread):
    sq, skv, masking, causal, dtype = CASES[case]
    q, k, v = _qkv(len(case), sq=sq, skv=skv)
    am = None if masking is None else _padding(3, 2, skv)
    jm = tm = None
    if am is not None:
        jm, tm = jnp.asarray(am), torch.from_numpy(am)
        if masking == "4d":
            jm, tm = jattention.padding_mask(jm), attention.padding_mask(tm)
    want = jflash(*(jnp.asarray(a, JAX_DTYPE[dtype]) for a in (q, k, v)),
                  mask=jm, causal=causal, interpret=True)
    got = fa.flash_attention(
        *(torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in (q, k, v)),
        mask=tm, causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **FWD_TOL[dtype])


@pytest.mark.parametrize("causal,masking", [(False, True), (True, False),
                                            (True, True)])
def test_grads_match_tpudl(causal, masking, one_thread):
    q, k, v = _qkv(7, sq=48, skv=64)
    am = _padding(8, 2, 64) if masking else None
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)

    def loss_j(q, k, v):
        o = jflash(q, k, v, mask=None if am is None else jnp.asarray(am),
                   causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss_j, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention(*leaves, mask=None if am is None else
                           torch.from_numpy(am), causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("sq,causal", [(160, False), (96, True)])
def test_dead_kv_blocks_get_zero_dk_dv_like_tpudl(sq, causal, one_thread):
    """A 128-row kv block that the padding mask leaves dead (kv rows 128 ..
    159 of batch row 0) gets dK = dV = 0 exactly, in tpudl's backward and
    in the port's (the dK/dV kernel writes zeros there and runs no
    product), and the gradients agree; causal with Sq 96 != Skv 160."""
    skv = 160
    q, k, v = _qkv(29, sq=sq, skv=skv)
    am = (np.arange(skv)[None, :] < np.array([100, 160])[:, None]).astype(
        np.int32)
    g = np.random.default_rng(30).normal(size=q.shape).astype(np.float32)

    def loss_j(q, k, v):
        o = jflash(q, k, v, mask=jnp.asarray(am), causal=causal,
                   interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    want = jax.grad(loss_j, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention(*leaves, mask=torch.from_numpy(am), causal=causal)
    (o * torch.from_numpy(g)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    for grad in (leaves[1].grad, leaves[2].grad, *want[1:]):
        assert not np.asarray(grad)[0, 128:].any()
    assert leaves[1].grad[1, 128:].abs().amax() > 0


def test_with_lse_and_its_cotangent_match_tpudl(one_thread):
    """lse [B, H, Sq] and the gradients of a loss that reads both outputs
    (the lse cotangent folds into delta)."""
    q, k, v = _qkv(11, sq=64, skv=96)
    am = _padding(12, 2, 96)
    rng = np.random.default_rng(13)
    go = rng.normal(size=q.shape).astype(np.float32)
    gl = rng.normal(size=(2, 2, 64)).astype(np.float32)

    def loss_j(q, k, v):
        o, lse = jflash_lse(q, k, v, mask=jnp.asarray(am), causal=True,
                            interpret=True)
        return jnp.sum(o * go) + jnp.sum(lse * gl)

    jo, jl = jflash_lse(*(jnp.asarray(a) for a in (q, k, v)),
                        mask=jnp.asarray(am), causal=True, interpret=True)
    want = jax.grad(loss_j, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*leaves, torch.from_numpy(am),
                                         causal=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 64)
    np.testing.assert_allclose(_np(o), np.asarray(jo), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(lse), np.asarray(jl), rtol=1e-5, atol=1e-4)
    ((o * torch.from_numpy(go)).sum()
     + (lse * torch.from_numpy(gl)).sum()).backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_fully_masked_rows_match_tpudl(one_thread):
    """A row that attends to nothing: o = 0 and lse = MASK_VALUE, as
    tpudl's kernel (not the reference's uniform softmax)."""
    q, k, v = _qkv(14, sq=64, skv=64)
    am = _padding(15, 2, 64)
    am[1] = 0
    jo, jl = jflash_lse(*(jnp.asarray(a) for a in (q, k, v)),
                        mask=jnp.asarray(am), interpret=True)
    o, lse = fa.flash_attention_with_lse(*(torch.from_numpy(a)
                                           for a in (q, k, v)),
                                         torch.from_numpy(am))
    np.testing.assert_allclose(_np(o), np.asarray(jo), rtol=1e-5, atol=1e-4)
    assert float(o[1].abs().max()) == 0.0
    assert bool((lse[1] == attention.MASK_VALUE).all())
    np.testing.assert_array_equal(_np(lse[1]), np.asarray(jl)[1])


def test_dense_mask_is_rejected():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, sq=8, skv=8))
    with pytest.raises(NotImplementedError, match="dense mask"):
        fa.flash_attention(q, k, v, torch.ones(2, 2, 8, 8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="dense mask"):
        jflash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
               mask=jnp.ones((2, 2, 8, 8), bool), interpret=True)


def _composite_dropout(q, k, v, am, seed, rate, causal):
    """Attention with dropout after normalization, the keep mask from
    ops/keep_mask.py: softmax in f32, kept probabilities / (1 - rate)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    mask = attention.combine_kv_causal_mask(torch.from_numpy(am), q.shape[1],
                                            k.shape[1], causal, "cpu")
    s = torch.where(mask, s, attention.MASK_VALUE)
    p = torch.softmax(s, -1)
    keep = keep_mask.keep_mask(seed, p.shape, rate)
    p = torch.where(keep, p / (1.0 - rate), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_matches_a_composite_with_the_keep_mask(causal, one_thread):
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, sq=64, skv=64))
    am = _padding(17, 2, 64)
    rate = 0.1
    got = fa.flash_attention(q, k, v, torch.from_numpy(am), causal=causal,
                             dropout_rate=rate,
                             dropout_rng=torch.Generator().manual_seed(3))
    seed = keep_mask.draw_seed(torch.Generator().manual_seed(3))
    want = _composite_dropout(q, k, v, am, seed, rate, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    undropped = fa.flash_attention(q, k, v, torch.from_numpy(am),
                                   causal=causal)
    assert not torch.allclose(got, undropped)


def test_dropout_matches_hybrid_attention_on_the_same_seed_words(one_thread):
    """The same generator seed draws the same two seed words in both, so
    flash's keep mask is hybrid_attention's bit for bit: the outputs
    agree to f32 roundoff and so do their gradients."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(18, sq=128, skv=128))
    am = torch.from_numpy(_padding(19, 2, 128))
    outs = []
    for fn in (fa.flash_attention, hybrid_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves, am, causal=True, dropout_rate=0.1,
               dropout_rng=torch.Generator().manual_seed(21))
        (o * o).sum().backward()
        outs.append([o] + [t.grad for t in leaves])
    for a, b in zip(*outs):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_backward_is_autograd_through_plain_forward(rate):
    """flash_attention_bwd_ref (the backward kernels' plain version, from
    lse and delta) is the gradient of flash_attention_ref with the same
    seed words, lse cotangent included."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(22, sq=40, skv=56))
    kvmask = torch.from_numpy(_padding(23, 2, 56)).bool()
    seed = torch.tensor([7, 2**32 - 9], dtype=torch.int64)
    rng = np.random.default_rng(24)
    go = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    gl = torch.from_numpy(rng.normal(size=(2, 2, 40)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = fa.flash_attention_ref(*leaves, kvmask, seed, True, None, rate)
    ((o * go).sum() + (lse * gl).sum()).backward()
    delta = fa.backward_delta(go, o.detach(), gl)
    got = fa.flash_attention_bwd(q, k, v, kvmask, seed, go, lse.detach(),
                                 delta, True, None, rate)
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5)


def test_attend_flash_and_long_fused_dispatch(one_thread):
    q, k, v = _qkv(25, sq=64, skv=64)
    am = _padding(26, 2, 64)
    want = jattention.attend(*(jnp.asarray(a) for a in (q, k, v)),
                             mask=jnp.asarray(am), causal=True,
                             implementation="flash")
    got = attention.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                           mask=torch.from_numpy(am), causal=True,
                           implementation="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    # "fused" past S = 512 falls through to flash, as in tpudl.
    big = torch.from_numpy(np.random.default_rng(27).normal(
        size=(1, 520, 1, 32)).astype(np.float32))
    np.testing.assert_array_equal(
        attention.attend(big, big, big, causal=True,
                         implementation="fused").numpy(),
        fa.flash_attention(big, big, big, causal=True).numpy())
    for impl, item in (("ring", "item 10"), ("ulysses", "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            attention.attend(big, big, big, implementation=impl)


def test_dispatch_rules_and_counters():
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(28, sq=8, skv=8))
    before = (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
              fa.flash_attention.launches_dkv)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (fa.flash_attention.launches_fwd, fa.flash_attention.launches_dq,
            fa.flash_attention.launches_dkv) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(q, k, v, impl="fused")
    with pytest.raises(ValueError, match="dropout_rng"):
        fa.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        fa.flash_attention(q, k, v, dropout_rate=1.0,
                           dropout_rng=torch.Generator())
    # At rate 0 a call draws nothing from the generator.
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    fa.flash_attention(q, k, v, dropout_rng=g1)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("shape", [(2, 3, 5, 70), (1, 2, 7, 301),
                                   (2, 1, 4, 33), (1, 1, 3, 64)])
def test_keep_words_are_the_keep_mask_in_row_order(shape):
    """``keep_words`` (the plain twin of the row-order keep bits the bf16
    dQ launches hand their dK/dV launches) is ``keep_mask`` packed bit for
    bit: bit kv % 32 of word kv // 32, bits past Skv clear, at Skv % 32
    != 0 and Skv % 4 != 0. Packed here independently with numpy."""
    b, h, sq, skv = shape
    seed = torch.tensor([12345, 2**32 - 77], dtype=torch.int64)
    words = keep_mask.keep_words(seed, b, h, sq, skv, 0.3)
    nwords = -(-skv // 32)
    assert words.dtype == torch.int32 and words.shape == (b, h, sq, nwords)
    kept = keep_mask.keep_mask(seed, shape, 0.3).numpy()
    padded = np.zeros((b, h, sq, 32 * nwords), dtype=bool)
    padded[..., :skv] = kept
    want = np.packbits(padded, axis=-1, bitorder="little").view("<u4")
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert 0.6 < kept.mean() < 0.8
