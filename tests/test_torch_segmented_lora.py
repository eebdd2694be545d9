"""tpudl_torch.ops.segmented_lora against tpudl.ops.segmented_lora on the
CPU.

The same pools, tables, scales and activations, made with numpy from a
seed, go through tpudl's ``segmented_lora`` (its Pallas kernel in
interpret mode, ``impl="fused"``, and its XLA composite, as
tests/test_tenant_lora.py runs them) and the port's plain version
(``impl="auto"`` on CPU tensors), at tpudl's tolerance rtol 2e-5 / atol
2e-6 (tests/test_tenant_lora.py:123): f32 and int8 pools, [B, H] and
[B, S, H] activations, ragged ranks (short ranks on the zero page) and
an empty slot. The int8 page rule (``_quantize_rows``) is held bit for
bit against tpudl's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudl.ops.segmented_lora import segmented_lora as jseg
from tpudl.serve.lora import _quantize_rows as jquantize_rows
from tpudl_torch.ops import segmented_lora as sl
from tpudl_torch.serve.lora import _quantize_rows

TABLE = np.array([[1, 2, 3], [4, 0, 0], [0, 0, 0], [5, 6, 0]], np.int32)
SCALE = np.array([0.5, 2.0, 0.0, 1.0], np.float32)


def _pools(seed, num_pages=9, h=24, o=40, quantized=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(num_pages, h)).astype(np.float32)
    b = rng.normal(size=(num_pages, o)).astype(np.float32)
    a[0] = b[0] = 0.0  # page 0 is the all-zero page by contract
    if not quantized:
        return {"a": a, "b": b}
    qa, sa = _quantize_rows(a)
    qb, sb = _quantize_rows(b)
    return {"a": qa, "b": qb, "a_scale": sa, "b_scale": sb}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seq", [None, 3])
@pytest.mark.parametrize("jimpl", ["fused", "reference"])
def test_plain_version_matches_tpudl(quantized, seq, jimpl):
    pools = _pools(0, quantized=quantized)
    rng = np.random.default_rng(1)
    shape = (4, 24) if seq is None else (4, seq, 24)
    x = rng.normal(size=shape).astype(np.float32)
    want = jseg(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pools.items()},
                TABLE, SCALE, impl=jimpl)
    got = sl.segmented_lora(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in pools.items()},
                            torch.from_numpy(TABLE), torch.from_numpy(SCALE))
    assert got.shape == x.shape[:-1] + (40,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)
    # The empty slot contributes exactly zero.
    assert not got[2].any()


def test_plain_version_is_the_hand_computed_delta():
    pools = _pools(2)
    x = np.random.default_rng(3).normal(size=(4, 2, 24)).astype(np.float32)
    got = sl.segmented_lora_ref(torch.from_numpy(x),
                                {k: torch.from_numpy(v) for k, v in pools.items()},
                                TABLE, SCALE).numpy()
    a, b = pools["a"][TABLE[0]].T, pools["b"][TABLE[0]]
    np.testing.assert_allclose(got[0], 0.5 * (x[0] @ a) @ b, rtol=1e-5,
                               atol=1e-5)
    # A short rank: slot 1 uses one page.
    np.testing.assert_allclose(
        got[1], 2.0 * (x[1] @ pools["a"][[4]].T) @ pools["b"][[4]], rtol=1e-5,
        atol=1e-5)


def test_bf16_activations_round_once_to_bf16():
    pools = _pools(4)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 24)).astype(np.float32)).bfloat16()
    tp = {k: torch.from_numpy(v) for k, v in pools.items()}
    got = sl.segmented_lora(x, tp, TABLE, SCALE)
    assert got.dtype == torch.bfloat16
    want = sl.segmented_lora(x.float(), tp, TABLE, SCALE).bfloat16()
    assert torch.equal(got, want)


def test_base_is_the_callers_add():
    """``base=y`` returns ``y + delta`` with the rounding of the add the
    caller would make (tpudl's ``q = q + delta`` in the compute dtype)."""
    tp = {k: torch.from_numpy(v) for k, v in _pools(8).items()}
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(4, 3, 24)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4, 3, 40)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xd, yd = x.to(dtype), y.to(dtype)
        got = sl.segmented_lora(xd, tp, TABLE, SCALE, base=yd)
        assert torch.equal(got, yd + sl.segmented_lora(xd, tp, TABLE, SCALE))


def test_quantize_rows_is_tpudl_bit_for_bit():
    rows = np.random.default_rng(6).normal(size=(5, 33)).astype(np.float32)
    rows[2] = 0.0  # the scale floor
    q, s = _quantize_rows(rows)
    jq, js = jquantize_rows(rows)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)


def test_refusals_and_counter():
    pools = {k: torch.from_numpy(v) for k, v in _pools(7).items()}
    x = torch.zeros(4, 24)
    with pytest.raises(ValueError, match="pool dict"):
        sl.segmented_lora(x, {"a": pools["a"]}, TABLE, SCALE)
    with pytest.raises(ValueError, match=r"\[B, H\] or \[B, S, H\]"):
        sl.segmented_lora(torch.zeros(24), pools, TABLE, SCALE)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sl.segmented_lora(x, pools, TABLE, SCALE, impl="fused")
    with pytest.raises(ValueError, match=r"\[0, 9\)"):
        sl.check_table(np.array([[1, 9]]), 9)
    sl.check_table(TABLE, 9)
    before = sl.segmented_lora.launches
    sl.segmented_lora(x, pools, TABLE, SCALE)
    assert sl.segmented_lora.launches == before
