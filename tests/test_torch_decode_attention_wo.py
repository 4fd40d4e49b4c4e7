"""K8 / K8u parity: the port's plain versions of decode attention with the
wo projection fused (with and without the residual epilogue) and with the
cache write fused, against prego_tpu's decode_attention_bounded_wo and
decode_attention_bounded_wo_res_upd (interpret mode, t_block=256), on the
same numpy inputs at the JAX tests' shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.decode_attention import (
    decode_attention_bounded_wo,
    decode_attention_bounded_wo_res_upd,
)
from prego_tpu_torch.ops import decode_attention_wo as port
from prego_tpu_torch.ops.decode_attention import decode_attention_reference
from tests.torch_parity import n, t

# f32 on both sides. The Pallas walk keeps an online max over 256-position
# blocks, the plain version one softmax over the row: the attention output
# differs by summation order (2e-5, K2's parity bar), and the projection
# sums H x hd = 1024 such values against |wo| ~ 0.05, about 2e-5 again
TOL = dict(rtol=1e-4, atol=1e-4)
B, KV, R, HD, T, D = 3, 4, 2, 128, 512, 256


def _inputs(seed, valid):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    wo = rng.normal(0, 0.05, (KV * R * HD, D)).astype(np.float32)
    h = rng.normal(0, 1, (B, 1, D)).astype(np.float32)
    # positions past the bound hold garbage that must not leak
    k[:, :, valid:] = 1e4
    v[:, :, valid:] = -1e4
    return q, k, v, wo, h


@pytest.mark.parametrize("valid", [0, 1, 137, 512])
def test_wo_fusion_matches_pallas(valid):
    q, k, v, wo, h = _inputs(valid + 5, valid)
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = decode_attention_bounded_wo(*jargs, jnp.int32(valid), jnp.asarray(wo), t_block=256,
                                       interpret=True)
    got = port.decode_attention_wo(t(q), t(k), t(v), valid, t(wo))
    assert got.shape == (B, 1, D) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)
    if valid == 0:  # zeros through the projection, as K2 gives
        assert torch.all(got == 0)

    # the residual epilogue: h + proj in h's dtype
    want_res = decode_attention_bounded_wo(*jargs, jnp.int32(valid), jnp.asarray(wo),
                                           t_block=256, interpret=True, residual=jnp.asarray(h))
    got_res = port.decode_attention_wo(t(q), t(k), t(v), valid, t(wo), residual=t(h))
    assert got_res.shape == (B, 1, D) and got_res.dtype == torch.float32
    np.testing.assert_allclose(n(got_res), n(want_res), **TOL)
    # and it is exactly the unfused add of the plain projection
    assert torch.equal(got_res, t(h) + got)


def test_wo_fusion_per_row_bounds_and_bf16():
    """(B,) bounds (the kernel takes them; the JAX kernel is scalar-only):
    each row equals its own scalar-bound call, up to the order in which
    the CPU's BLAS sums a batch of rows against one row (f32 ulps). In
    bf16 the result keeps the residual's dtype and stays within bf16
    rounding of f32."""
    q, k, v, wo, h = _inputs(3, T)
    valid = np.array([0, 64, 300], np.int32)
    got = port.decode_attention_wo(t(q), t(k), t(v), t(valid), t(wo), residual=t(h))
    for b, vb in enumerate(valid):
        row = port.decode_attention_wo(t(q[b : b + 1]), t(k[b : b + 1]), t(v[b : b + 1]),
                                       int(vb), t(wo), residual=t(h[b : b + 1]))
        np.testing.assert_allclose(n(got[b : b + 1]), n(row), rtol=1e-5, atol=1e-5)
    bf = torch.bfloat16
    got16 = port.decode_attention_wo(t(q, bf), t(k, bf), t(v, bf), t(valid), t(wo, bf),
                                     residual=t(h, bf))
    assert got16.dtype == bf
    # bf16 operands (2^-9 relative) over 1024 products of size ~0.05 x 4
    # and the output's own rounding at |out| < 4: 2^-4 absolute
    np.testing.assert_allclose(n(got16), n(got), rtol=0, atol=2.0 ** -4)


@pytest.mark.parametrize("pos", [0, 13, 136, 511])
def test_cache_upd_matches_pallas_and_writes_the_same_cache(pos):
    rng = np.random.default_rng(pos + 17)
    q, k0, v0, wo, h = _inputs(pos + 11, T)
    kn = rng.normal(0, 1, (B, KV, 1, HD)).astype(np.float32)
    vn = rng.normal(0, 1, (B, KV, 1, HD)).astype(np.float32)
    want, ck, cv = decode_attention_bounded_wo_res_upd(
        jnp.asarray(q), jnp.asarray(h), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(k0),
        jnp.asarray(v0), jnp.int32(pos), jnp.asarray(wo), t_block=256, interpret=True)
    cache_k, cache_v = t(k0), t(v0)
    got, gk, gv = port.decode_attention_wo_res_upd(
        t(q), t(h), t(kn), t(vn), cache_k, cache_v, pos, t(wo))
    assert gk is cache_k and gv is cache_v  # written in place
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_array_equal(n(cache_k), np.asarray(ck))
    np.testing.assert_array_equal(n(cache_v), np.asarray(cv))
    # and it is write-then-attend: the K/V at pos come from k_new / v_new
    k_ref, v_ref = k0.copy(), v0.copy()
    k_ref[:, :, pos], v_ref[:, :, pos] = kn[:, :, 0], vn[:, :, 0]
    attn = port.decode_attention_wo(t(q), t(k_ref), t(v_ref), pos + 1, t(wo), residual=t(h))
    assert torch.equal(got, attn)


def test_cache_upd_per_row_positions():
    """(B,) positions: each row writes and attends at its own pos."""
    rng = np.random.default_rng(8)
    q, k0, v0, wo, h = _inputs(8, T)
    kn = rng.normal(0, 1, (B, KV, 1, HD)).astype(np.float32)
    vn = rng.normal(0, 1, (B, KV, 1, HD)).astype(np.float32)
    pos = np.array([63, 64, 65], np.int32)  # the split boundary of the card's walk
    cache_k, cache_v = t(k0), t(v0)
    got, _, _ = port.decode_attention_wo_res_upd(
        t(q), t(h), t(kn), t(vn), cache_k, cache_v, t(pos), t(wo))
    for b, p in enumerate(pos):
        np.testing.assert_array_equal(n(cache_k[b, :, p]), kn[b, :, 0])
        np.testing.assert_array_equal(n(cache_v[b, :, p]), vn[b, :, 0])
        others = np.ones(T, bool)
        others[p] = False
        np.testing.assert_array_equal(n(cache_k[b])[:, others], k0[b][:, others])
    want = port.decode_attention_wo(t(q), cache_k, cache_v, t(pos + 1), t(wo), residual=t(h))
    assert torch.equal(got, want)


def test_wrappers_take_plain_versions_on_cpu():
    q, k, v, wo, h = _inputs(6, 64)
    before = (port.KERNEL.launches, port.KERNEL_UPD.launches)
    out = port.decode_attention_wo(t(q), t(k), t(v), 64, t(wo))
    upd, _, _ = port.decode_attention_wo_res_upd(
        t(q), t(h), t(k[:, :, :1]), t(v[:, :, :1]), t(k), t(v), 63, t(wo))
    assert (port.KERNEL.launches, port.KERNEL_UPD.launches) == before
    o = decode_attention_reference(t(q), t(k), t(v), 64).reshape(B, 1, -1)
    assert torch.equal(out, o @ t(wo))
    assert upd.shape == (B, 1, D)
    assert jax.devices()[0].platform == "cpu"  # the JAX side ran on the CPU
