"""Fused-FFN parity: the port's plain version of K7a against prego_tpu's
fused_ffn_block (interpret mode) and against the unfused JAX sequence
rms_norm -> _feed_forward -> + h, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama.model import _feed_forward, rms_norm
from prego_tpu.ops.fused_ffn import fused_ffn_block as jax_fused_ffn_block
from prego_tpu_torch.ops import fused_ffn as port
from tests.torch_parity import n, t

# f32 on both sides: the Pallas kernel sums W2 over F tiles, the plain
# version in one product; summation order only
TOL = dict(rtol=2e-5, atol=2e-5)
EPS = 1e-5


def _inputs(seed, M, D, F):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (M, D)).astype(np.float32)
    nw = rng.normal(1, 0.1, (D,)).astype(np.float32)
    w13 = rng.normal(0, 0.05, (D, 2 * F)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (F, D)).astype(np.float32)
    return h, nw, w13, w2


@pytest.mark.parametrize("M,D,F", [(1, 128, 256), (8, 256, 512), (5, 128, 384)])
def test_matches_pallas_interpret(M, D, F):
    h, nw, w13, w2 = _inputs(M + F, M, D, F)
    want = jax_fused_ffn_block(
        jnp.asarray(h), jnp.asarray(nw), jnp.asarray(w13), jnp.asarray(w2), EPS,
        f_block=128, interpret=True,
    )
    got = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("M,D,F", [(2, 64, 176), (8, 128, 256)])
def test_matches_unfused_jax_sequence(M, D, F):
    h, nw, w13, w2 = _inputs(3 * M + F, M, D, F)
    jh = jnp.asarray(h)
    want = jh + _feed_forward(
        {"w13": jnp.asarray(w13), "w2": jnp.asarray(w2)}, rms_norm(jh, jnp.asarray(nw), EPS)
    )
    got = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_rms_norm_dtype_walk_matches_jax_bf16():
    """bf16: f32 statistics, normed cast to bf16, then the bf16 product
    with the weight. Same roundings on both sides: equal bits."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 64)).astype(np.float32)
    w = rng.normal(1, 0.2, (64,)).astype(np.float32)
    want = rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), EPS)
    got = port.rms_norm(t(x, torch.bfloat16), t(w, torch.bfloat16), EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), n(want))


def test_wrapper_takes_plain_version_on_cpu():
    h, nw, w13, w2 = _inputs(0, 2, 64, 128)
    before = port.KERNEL.launches
    out = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    assert port.KERNEL.launches == before
    assert torch.equal(out, port.fused_ffn_block_reference(t(h), t(nw), t(w13), t(w2), EPS))
