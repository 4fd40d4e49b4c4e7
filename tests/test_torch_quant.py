"""int8 quantization parity: the port's quantize_weight,
quantize_activations, _kv_quantize and the plain versions of K4
(int8_matmul) and K5 (int8xint8_matmul) against prego_tpu's, the Pallas
kernels in interpret mode, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama.model import _kv_quantize as jax_kv_quantize
from prego_tpu.ops import quant as jq
from prego_tpu_torch.models.llama.model import _kv_quantize
from prego_tpu_torch.ops import quant
from tests.torch_parity import n, t

# K4: products of a bf16 and an int8 value are exact in f32 on both sides;
# the f32 sums of K products differ by their order only
K4_TOL = dict(rtol=1e-5, atol=1e-5)
# K5: the int32 sums are exact on both sides and are rounded once to f32,
# then multiplied by x_scale and by the channel scale in the same order
K5_TOL = dict(rtol=2.0 ** -23, atol=0)


def _with_ties(rng, shape):
    """Normal values, a zero column (the 1e-8 scale floor) and a column
    whose scale is exactly 1 with half-integer values (round half to even)."""
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    w[:, 0] = 0.0
    ties = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32), shape[0])
    w[:, 1] = ties
    return w


def _ulps(a, b):
    """Largest distance between two f32 arrays in units in the last place."""
    ai, bi = np.asarray(a, np.float32).view(np.int32), np.asarray(b, np.float32).view(np.int32)
    return int(np.abs(ai.astype(np.int64) - bi.astype(np.int64)).max())


@pytest.mark.parametrize("shape", [(64, 128), (300, 7), (4096 // 16, 96)])
def test_quantize_weight_matches_jax(shape):
    w = _with_ties(np.random.default_rng(sum(shape)), shape)
    jqv, js = jq.quantize_weight(jnp.asarray(w))
    q, s = quant.quantize_weight(t(w))
    assert q.dtype == torch.int8 and tuple(s.shape) == (1, shape[1])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert _ulps(s.numpy(), js) <= 1
    # bf16 weights quantize from their f32 values, as the JAX package does
    qb, sb = quant.quantize_weight(t(w, torch.bfloat16))
    jqb, jsb = jq.quantize_weight(jnp.asarray(w).astype(jnp.bfloat16))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))
    assert _ulps(sb.numpy(), jsb) <= 1


@pytest.mark.parametrize("M,K", [(1, 128), (8, 4096 // 8), (300, 64)])
def test_quantize_activations_matches_jax(M, K):
    x = np.random.default_rng(M + K).normal(0, 2, (M, K)).astype(np.float32)
    x[0, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]  # scale 1: ties round to even
    if M > 1:
        x[1] = 0.0  # the 1e-8 floor
    jqv, js = jq.quantize_activations(jnp.asarray(x))
    q, s = quant.quantize_activations(t(x))
    assert tuple(s.shape) == (M, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert _ulps(s.numpy(), js) <= 1


def test_kv_quantize_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 4, 5, 128)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-8 floor
    x[1, 1, 1, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]
    x[1, 1, 1, 7:] = 0.25
    jqv, js = jax_kv_quantize(jnp.asarray(x))
    q, s = _kv_quantize(t(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == (2, 4, 5)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert _ulps(s.numpy(), js) <= 1


def _matmul_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    q, s = (np.asarray(a) for a in jq.quantize_weight(jnp.asarray(w)))
    return x, q, s


# M 300 passes the JAX kernel's 256-row block (padded there); N 1000 is no
# multiple of a lane-aligned tile; M 520 is a prefill past two such blocks
# (the card takes it on its wgmma tile path)
SHAPES = [(1, 128, 512), (8, 128, 512), (300, 64, 1000), (520, 256, 384)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_plain_matches_pallas(M, K, N):
    x, q, s = _matmul_inputs(M, K, N, M + N)
    kern = jq.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), interpret=True)
    ref = jq.int8_matmul_reference(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s))
    got = quant.int8_matmul(t(x), t(q), t(s))  # f32 x: rounded to bf16 first, as in JAX
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(n(got), n(kern), **K4_TOL)
    np.testing.assert_allclose(n(got), n(ref), **K4_TOL)
    # bf16 x gives the same result
    np.testing.assert_allclose(n(quant.int8_matmul(t(x, torch.bfloat16), t(q), t(s))), n(got),
                               **K4_TOL)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8xint8_matmul_plain_matches_pallas(M, K, N):
    x, q, s = _matmul_inputs(M, K, N, 7 * M + N)
    jxq, jxs = jq.quantize_activations(jnp.asarray(x))
    xq, xs = quant.quantize_activations(t(x))
    kern = jq.int8xint8_matmul(jxq, jxs, jnp.asarray(q), jnp.asarray(s), interpret=True)
    ref = jq.int8xint8_matmul_reference(jxq, jxs, jnp.asarray(q), jnp.asarray(s))
    got = quant.int8xint8_matmul(xq, xs, t(q), t(s))
    np.testing.assert_allclose(n(got), n(kern), **K5_TOL)
    np.testing.assert_allclose(n(got), n(ref), **K5_TOL)


def test_int8xint8_sums_are_exact_past_f32():
    """Sums above 2^24, where f32 accumulation would round: the plain K5
    keeps the exact int32 sum, rounded once."""
    K = 4096
    xq = torch.full((2, K), 127, dtype=torch.int8)
    q = torch.full((K, 8), 127, dtype=torch.int8)
    q[0, :] = 1  # 127 * (127 * 4095 + 1): not a multiple of 4, the f32 spacing there
    one = torch.ones(1, 8)
    got = quant.int8xint8_matmul(xq, torch.ones(2, 1), q, one)
    exact = 127 * (127 * (K - 1) + 1)
    assert exact > 2 ** 24
    assert float(got[0, 0]) == float(np.float32(exact))


def test_wrappers_take_plain_versions_on_cpu():
    x, q, s = _matmul_inputs(3, 64, 24, 1)
    before = (quant.KERNEL_W8.launches, quant.KERNEL_W8A8.launches)
    y = quant.int8_matmul(t(x), t(q), t(s))
    xq, xs = quant.quantize_activations(t(x))
    y8 = quant.int8xint8_matmul(xq, xs, t(q), t(s))
    assert (quant.KERNEL_W8.launches, quant.KERNEL_W8A8.launches) == before
    assert torch.equal(y, quant.int8_matmul_reference(t(x), t(q), t(s)))
    assert torch.equal(y8, quant.int8xint8_matmul_reference(xq, xs, t(q), t(s)))
