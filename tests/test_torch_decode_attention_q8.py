"""int8-KV decode-attention parity: the port's plain version of K3 against
prego_tpu's decode_attention_bounded_q8 (interpret mode, t_block=256) on
the same numpy inputs, including its batch-folded and flat-head bodies;
and K3m, its int8_mxu=True mode, whose plain version and JAX kernel are
each held to the f32 reference on the dequantized cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.decode_attention import decode_attention_bounded_q8
from prego_tpu.ops.decode_attention import decode_attention_reference as jax_f32_reference
from prego_tpu_torch.models.llama.model import _kv_quantize
from prego_tpu_torch.ops import decode_attention_q8 as port
from tests.torch_parity import n, t

HD, T = 128, 512
# Both sides round q to bf16, sum exact q.k products in f32, and round
# p * v_scale to bf16 before an f32 value product. Within one 256-position
# block of the JAX walk the two agree to the f32 summation order (1e-5 of
# the max-norm). Past it, the JAX walk rounds the first block's p against
# that block's running max while the plain version uses the row's max: a
# pv of the first block then differs by up to 2^-8 of itself, and the
# output by an average of such differences with random signs. Stated
# against the max-norm of the output: 5e-3 for the largest difference and
# 1e-3 for the mean (the JAX package's own test allows 1e-2 and 3e-3
# against its f32 reference, which does not round at all).
ONE_BLOCK_TOL = 1e-5
MAX_TOL, MEAN_TOL = 5e-3, 1e-3


def _inputs(seed, B, KV, R, valid):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, KV, R, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, KV, T, HD)).astype(np.float32)
    # positions past each row's bound hold values that must not leak
    for b, vb in enumerate(np.broadcast_to(valid, (B,))):
        k[b, :, vb:] = 50.0
        v[b, :, vb:] = -50.0
    kq, ks = _kv_quantize(t(k))
    vq, vs = _kv_quantize(t(v))
    return q, kq, ks, vq, vs


def _jax(q, kq, ks, vq, vs, valid, **kw):
    return decode_attention_bounded_q8(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()), jnp.asarray(valid),
        t_block=256, interpret=True, **kw,
    )


def _check(got, want, one_block):
    err = np.abs(n(got) - n(want))
    norm = np.abs(n(want)).max()
    if one_block:
        assert err.max() / norm < ONE_BLOCK_TOL
    assert err.max() / norm < MAX_TOL
    assert err.mean() / norm < MEAN_TOL


@pytest.mark.parametrize("valid", [1, 100, 256, 300, 512])
@pytest.mark.parametrize("R", [1, 2])
def test_scalar_valid_matches_pallas(valid, R):
    q, kq, ks, vq, vs = _inputs(valid + R, 2, 4, R, valid)
    want = _jax(q, kq, ks, vq, vs, np.int32(valid))
    got = port.decode_attention_q8(t(q), kq, ks, vq, vs, valid)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, R, HD)
    _check(got, want, valid <= 256)


@pytest.mark.parametrize("R", [1, 2])
def test_per_row_valid_matches_pallas(R):
    valid = np.array([300, 77], np.int32)
    q, kq, ks, vq, vs = _inputs(11 + R, 2, 4, R, valid)
    want = _jax(q, kq, ks, vq, vs, valid)
    got = port.decode_attention_q8(t(q), kq, ks, vq, vs, t(valid))
    _check(got, want, False)
    # each row alone, at its own scalar bound, gives the same rows
    for b, vb in enumerate(valid):
        row = port.decode_attention_q8(t(q[b:b + 1]), kq[b:b + 1], ks[b:b + 1], vq[b:b + 1],
                                       vs[b:b + 1], int(vb))
        assert torch.equal(row[0], got[b])


@pytest.mark.parametrize("KV,kw", [(4, dict(fold_batch=True)), (8, dict(head_group=8))])
def test_folded_and_flat_head_bodies_match(KV, kw):
    """The batch-folded walk and the flat-head groups are TPU schedules of
    the same function: one port answers both."""
    valid = np.array([512, 100], np.int32)
    q, kq, ks, vq, vs = _inputs(5 + KV, 2, KV, 1, valid)
    want = _jax(q, kq, ks, vq, vs, valid, **kw)
    got = port.decode_attention_q8(t(q), kq, ks, vq, vs, t(valid))
    _check(got, want, False)


def test_valid_zero_gives_zeros():
    """valid == 0: the JAX kernel walks one fully masked block and returns
    zeros (l clamped at 1e-30); the port gives zeros too."""
    q, kq, ks, vq, vs = _inputs(2, 2, 4, 1, 512)
    assert np.all(n(_jax(q, kq, ks, vq, vs, np.int32(0))) == 0)
    assert torch.all(port.decode_attention_q8(t(q), kq, ks, vq, vs, 0) == 0)
    valid = np.array([0, 7], np.int32)
    rows = port.decode_attention_q8(t(q), kq, ks, vq, vs, t(valid))
    assert torch.all(rows[0] == 0) and torch.all(torch.isfinite(rows))


def test_bf16_query_keeps_its_dtype_and_wrapper_takes_plain_on_cpu():
    q, kq, ks, vq, vs = _inputs(6, 2, 4, 2, 200)
    before = port.KERNEL.launches
    got16 = port.decode_attention_q8(t(q, torch.bfloat16), kq, ks, vq, vs, 200)
    assert port.KERNEL.launches == before
    assert got16.dtype == torch.bfloat16
    # the kernel rounds q to bf16 anyway: only the output's rounding differs
    got32 = port.decode_attention_q8(t(q, torch.bfloat16).float(), kq, ks, vq, vs, 200)
    np.testing.assert_allclose(n(got16), n(got32), rtol=2.0 ** -8, atol=0)
    assert torch.equal(got16, port.decode_attention_q8_reference(
        t(q, torch.bfloat16), kq, ks, vq, vs, 200))


# K3m: the JAX package's bars for int8_mxu against the f32 reference on
# the dequantized cache (tests/test_decode_attention.py:147-150), relative
# to the reference's max-norm. Most of that error is q's int8 rounding,
# which both sides share; the JAX test runs R = 1, and at R = 4 the JAX
# kernel itself reaches 1.04e-2 on some seeds, so the reference bars are
# held at R 1 and 2. The port quantizes pv against a 64-position split,
# the JAX kernel against its 256-position block: a code moves by at most
# one step of 1/16256 of the split's max, and the scales by an f32 ulp, so
# the two kernels agree within 1e-3 of the max-norm (largest) and 1e-4
# (mean) at every R (measured: 1.9e-4 and 2.9e-5).
MXU_MAX, MXU_MEAN = 0.01, 0.003
MXU_JAX_MAX, MXU_JAX_MEAN = 1e-3, 1e-4


def _rel_check(got, ref, max_tol, mean_tol):
    err = np.abs(n(got) - n(ref))
    norm = np.abs(n(ref)).max()
    assert err.max() / norm < max_tol
    assert err.mean() / norm < mean_tol


def _dequantized_reference(q, kq, ks, vq, vs, valid):
    k = kq.float() * ks[..., None]
    v = vq.float() * vs[..., None]
    return jax_f32_reference(jnp.asarray(q), jnp.asarray(n(k)), jnp.asarray(n(v)),
                             jnp.asarray(valid))


@pytest.mark.parametrize("valid", [1, 100, 256, 300, 512])
@pytest.mark.parametrize("R", [1, 2])
def test_int8_mxu_matches_the_f32_reference(valid, R):
    q, kq, ks, vq, vs = _inputs(3 * valid + R, 2, 4, R, valid)
    ref = _dequantized_reference(q, kq, ks, vq, vs, np.int32(valid))
    got = port.decode_attention_q8(t(q), kq, ks, vq, vs, valid, int8_mxu=True)
    want = _jax(q, kq, ks, vq, vs, np.int32(valid), int8_mxu=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, R, HD)
    _rel_check(got, ref, MXU_MAX, MXU_MEAN)
    _rel_check(want, ref, MXU_MAX, MXU_MEAN)
    _rel_check(got, want, MXU_JAX_MAX, MXU_JAX_MEAN)


@pytest.mark.parametrize("valid", [[0, 300], [77, 512], [512, 256]])
@pytest.mark.parametrize("R", [1, 4])
def test_int8_mxu_per_row_valid_matches_pallas(valid, R):
    """Per-row bounds, 0 among them (zeros for that row), and GQA rows."""
    valid = np.array(valid, np.int32)
    q, kq, ks, vq, vs = _inputs(int(valid.sum()) + R, 2, 4, R, valid)
    got = port.decode_attention_q8(t(q), kq, ks, vq, vs, t(valid), int8_mxu=True)
    _rel_check(got, _jax(q, kq, ks, vq, vs, valid, int8_mxu=True), MXU_JAX_MAX, MXU_JAX_MEAN)
    if valid[0] == 0:
        assert torch.all(got[0] == 0)


def test_int8_mxu_plain_version_quantizes_exactly():
    """The plain K3m's dots are exact: on a cache of small integers with
    unit scales and a query that quantizes to itself, its scores are the
    integer dot products times 1/sqrt(hd), and with one position the output
    is that position's value row (p = 1, pv quantized to 16256 / 16256)."""
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (1, 1, 1, HD)).astype(np.float32)
    q[0, 0, 0, 0] = 127  # qs = 1: q8 == q
    kq = torch.from_numpy(rng.integers(-127, 128, (1, 1, T, HD)).astype(np.int8))
    vq = torch.from_numpy(rng.integers(-127, 128, (1, 1, T, HD)).astype(np.int8))
    ones = torch.ones(1, 1, T)
    got = port.decode_attention_q8(t(q), kq, ones, vq, ones, 1, int8_mxu=True)
    assert torch.equal(got[0, 0, 0], vq[0, 0, 0].float())


def test_int8_mxu_takes_plain_version_on_cpu():
    q, kq, ks, vq, vs = _inputs(8, 2, 4, 2, 200)
    before = port.KERNEL_MXU.launches, port.KERNEL.launches
    got = port.decode_attention_q8(t(q, torch.bfloat16), kq, ks, vq, vs, 200, int8_mxu=True)
    assert (port.KERNEL_MXU.launches, port.KERNEL.launches) == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, port.decode_attention_q8_mxu_reference(
        t(q, torch.bfloat16), kq, ks, vq, vs, 200))
