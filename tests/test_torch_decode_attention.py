"""Decode-attention parity: the port's plain version of K2 against
prego_tpu's decode_attention_bounded (interpret mode, t_block=256),
decode_attention_reference and, for a scalar bound, the unbounded
decode_attention (K2u, interpret mode), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.decode_attention import (
    decode_attention,
    decode_attention_bounded,
    decode_attention_reference,
)
from prego_tpu_torch.ops import decode_attention as port
from tests.torch_parity import n, t

# f32 on both sides; the Pallas walk accumulates block by block with an
# online max, the plain version in one pass: summation order only
TOL = dict(rtol=2e-5, atol=2e-5)
B, KV, HD, T = 3, 2, 128, 512


def _inputs(seed, R, valid):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    # positions past each row's bound hold garbage that must not leak
    for b, vb in enumerate(np.broadcast_to(valid, (B,))):
        k[b, :, vb:] = 1e4
        v[b, :, vb:] = -1e4
    return q, k, v


@pytest.mark.parametrize("valid", [1, 100, 256, 300, 512])
@pytest.mark.parametrize("R", [1, 2])
def test_scalar_valid_matches_pallas_and_reference(valid, R):
    q, k, v = _inputs(valid + R, R, valid)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = decode_attention_bounded(jq, jk, jv, jnp.int32(valid), t_block=256, interpret=True)
    ref = decode_attention_reference(jq, jk, jv, jnp.int32(valid))
    # K2u walks every block with the same mask: one port covers both
    unbounded = decode_attention(jq, jk, jv, jnp.int32(valid), t_block=256, interpret=True)
    got = port.decode_attention(t(q), t(k), t(v), valid)
    np.testing.assert_allclose(n(got), n(kern), **TOL)
    np.testing.assert_allclose(n(got), n(ref), **TOL)
    np.testing.assert_allclose(n(got), n(unbounded), **TOL)


@pytest.mark.parametrize("R", [1, 2])
def test_per_row_valid_matches_pallas(R):
    valid = np.array([1, 512, 300], np.int32)  # 1, T and a mid-block bound
    q, k, v = _inputs(9 + R, R, valid)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = decode_attention_bounded(jq, jk, jv, jnp.asarray(valid), t_block=256, interpret=True)
    ref = decode_attention_reference(jq, jk, jv, jnp.asarray(valid))
    got = port.decode_attention(t(q), t(k), t(v), t(valid))
    np.testing.assert_allclose(n(got), n(kern), **TOL)
    np.testing.assert_allclose(n(got), n(ref), **TOL)


def test_long_cache_ragged_rows_match_pallas():
    """T 1024 (the card's kernel splits it over a cluster of 8 blocks of 128
    positions) with ragged per-row bounds: one short of a block, one past
    it, and the whole cache."""
    Tl, R = 1024, 2
    rng = np.random.default_rng(31)
    valid = np.array([127, 129, 1024], np.int32)
    q = rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, KV, Tl, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, KV, Tl, HD)).astype(np.float32)
    for b, vb in enumerate(valid):
        k[b, :, vb:] = 1e4
        v[b, :, vb:] = -1e4
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kern = decode_attention_bounded(jq, jk, jv, jnp.asarray(valid), t_block=256, interpret=True)
    ref = decode_attention_reference(jq, jk, jv, jnp.asarray(valid))
    got = port.decode_attention(t(q), t(k), t(v), t(valid))
    np.testing.assert_allclose(n(got), n(kern), **TOL)
    np.testing.assert_allclose(n(got), n(ref), **TOL)


def test_valid_zero_gives_zeros_like_the_kernel():
    """valid == 0: the Pallas kernel returns zeros (one fully masked block,
    l clamped); the port keeps that, not the reference's NaN softmax."""
    q, k, v = _inputs(2, 1, 512)
    kern = decode_attention_bounded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(0), t_block=256,
        interpret=True,
    )
    got = port.decode_attention(t(q), t(k), t(v), 0)
    assert np.all(n(kern) == 0)
    assert torch.all(got == 0)
    valid = np.array([0, 7, 0], np.int32)
    got_rows = port.decode_attention(t(q), t(k), t(v), t(valid))
    assert torch.all(got_rows[0] == 0) and torch.all(got_rows[2] == 0)
    assert torch.all(torch.isfinite(got_rows))


def test_zero_dim_tensor_valid_and_bf16_cast_of_p():
    """A 0-d tensor bound behaves as the scalar; with a bf16 cache the
    output keeps q's dtype and stays within bf16 rounding of f32."""
    q, k, v = _inputs(4, 2, 200)
    got = port.decode_attention(t(q), t(k), t(v), torch.tensor(200))
    want = port.decode_attention(t(q), t(k), t(v), 200)
    assert torch.equal(got, want)
    got16 = port.decode_attention(
        t(q, torch.bfloat16), t(k, torch.bfloat16), t(v, torch.bfloat16), 200
    )
    assert got16.dtype == torch.bfloat16
    # inputs rounded to bf16 (2^-8 relative) and p cast to bf16: outputs are
    # convex combinations of |v| < ~4, so 2^-4 absolute is the budget
    np.testing.assert_allclose(n(got16), n(want), rtol=0, atol=2.0 ** -4)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = _inputs(6, 1, 64)
    before = port.KERNEL.launches
    out = port.decode_attention(t(q), t(k), t(v), 64)
    assert port.KERNEL.launches == before
    assert torch.equal(out, port.decode_attention_reference(t(q), t(k), t(v), 64))
