"""int8-KV decode-attention parity: the port's plain version of K3 against
prego_tpu's decode_attention_bounded_q8 (interpret mode, t_block=256) on
the same numpy inputs, including its batch-folded and flat-head bodies."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.decode_attention import decode_attention_bounded_q8
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
