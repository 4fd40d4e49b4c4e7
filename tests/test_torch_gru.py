"""GRU parity: the port's plain recurrences against prego_tpu's gru_scan
and gru_pallas (interpret mode), on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.gru import gru_scan as jax_gru_scan
from prego_tpu.ops.gru_pallas import gru_pallas
from prego_tpu_torch.ops.gru import gru_cell, gru_scan
from prego_tpu_torch.ops.gru_cuda import gru_layer, gru_recurrence, gru_recurrence_reference
from tests.torch_parity import n, t

# f32 on both sides: only the summation order of the products differs
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 streaming (xg, W_hh and the h operand rounded to bf16, hs stored in
# bf16): identical roundings except where an f32 sum lands on the other
# side of a bf16 rounding boundary, one bf16 ulp (2^-8 relative) that the
# recurrence carries on; |h| < 1, so 2^-6 absolute bounds it over these T
BF16_TOL = dict(rtol=0, atol=2.0 ** -6)


def _params(seed, E, H):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    return {
        "w_ih": rng.uniform(-k, k, (E, 3 * H)).astype(np.float32),
        "b_ih": rng.uniform(-k, k, (3 * H,)).astype(np.float32),
        "w_hh": rng.uniform(-k, k, (H, 3 * H)).astype(np.float32),
        "b_hh": rng.uniform(-k, k, (3 * H,)).astype(np.float32),
    }


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: t(v) for k, v in p.items()}


@pytest.mark.parametrize("B,T", [(1, 1), (3, 13), (5, 24), (8, 7)])
def test_plain_scan_matches_jax_scan(B, T):
    E, H = 16, 12
    rng = np.random.default_rng(B * 100 + T)
    p = _params(B + T, E, H)
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    want_hs, want_hT = jax_gru_scan(jnp.asarray(x), jnp.asarray(h0), _jax(p))
    hs, hT = gru_scan(t(x), t(h0), _torch(p))
    np.testing.assert_allclose(n(hs), n(want_hs), **F32_TOL)
    np.testing.assert_allclose(n(hT), n(want_hT), **F32_TOL)


def test_gru_cell_matches_jax():
    from prego_tpu.ops.gru import gru_cell as jax_cell

    rng = np.random.default_rng(3)
    H = 10
    p = _params(3, H, H)
    xg = rng.normal(0, 1, (4, 3 * H)).astype(np.float32)
    h = rng.normal(0, 1, (4, H)).astype(np.float32)
    want = jax_cell(jnp.asarray(xg), jnp.asarray(h), jnp.asarray(p["w_hh"]), jnp.asarray(p["b_hh"]))
    got = gru_cell(t(xg), t(h), t(p["w_hh"]), t(p["b_hh"]))
    np.testing.assert_allclose(n(got), n(want), **F32_TOL)


@pytest.mark.parametrize("B,T", [(8, 16), (4, 13), (5, 9), (3, 1)])
def test_kernel_plain_version_matches_pallas_interpret_f32(B, T):
    """Ragged T (not a time_block multiple) and ragged B (not a batch
    block multiple): the Pallas wrapper pads and slices back, the port
    needs neither."""
    E, H = 16, 8
    rng = np.random.default_rng(B * 7 + T)
    p = _params(B * T, E, H)
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    h0 = np.zeros((B, H), np.float32)
    want_hs, want_hT = gru_pallas(jnp.asarray(x), jnp.asarray(h0), _jax(p), time_block=8,
                                  interpret=True)
    hs, hT = gru_layer(t(x), t(h0), _torch(p), stream_dtype=torch.float32)
    np.testing.assert_allclose(n(hs), n(want_hs), **F32_TOL)
    np.testing.assert_allclose(n(hT), n(want_hT), **F32_TOL)


@pytest.mark.parametrize("B,T", [(8, 16), (4, 13)])
def test_kernel_plain_version_matches_pallas_interpret_bf16(B, T):
    """The production dtype walk: xg and W_hh streamed as bf16."""
    E, H = 32, 16
    rng = np.random.default_rng(B + T)
    p = _params(11, E, H)
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    h0 = np.zeros((B, H), np.float32)
    want_hs, _ = gru_pallas(jnp.asarray(x), jnp.asarray(h0), _jax(p), time_block=8,
                            interpret=True, stream_dtype=jnp.bfloat16)
    hs, hT = gru_layer(t(x), t(h0), _torch(p), stream_dtype=torch.bfloat16)
    assert hs.dtype == torch.float32 and hT.dtype == torch.float32
    np.testing.assert_allclose(n(hs), n(want_hs), **BF16_TOL)
    # the carried state is the last frame's f32 state; hs holds it in bf16
    np.testing.assert_allclose(n(hT), n(hs[:, -1]), rtol=0, atol=2.0 ** -8)


def test_state_carried_across_chunks_matches_jax_scan():
    """Chunked streaming with carried state (the evaluator's usage) equals
    one pass over the whole sequence."""
    B, E, H, T = 4, 16, 8, 37
    rng = np.random.default_rng(5)
    p = _params(5, E, H)
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    want_hs, want_hT = jax_gru_scan(jnp.asarray(x), jnp.zeros((B, H)), _jax(p))
    h = torch.zeros(B, H)
    outs = []
    for t0 in range(0, T, 16):
        hs, h = gru_layer(t(x[:, t0 : t0 + 16]), h, _torch(p), stream_dtype=torch.float32)
        outs.append(n(hs))
    np.testing.assert_allclose(np.concatenate(outs, axis=1), n(want_hs), **F32_TOL)
    np.testing.assert_allclose(n(h), n(want_hT), **F32_TOL)


def test_recurrence_wrapper_takes_plain_version_on_cpu():
    T, B, H = 5, 3, 4
    rng = np.random.default_rng(0)
    xg = t(rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32)).to(torch.bfloat16)
    h0 = t(rng.normal(0, 1, (B, H)).astype(np.float32))
    w = t(rng.normal(0, 0.3, (H, 3 * H)).astype(np.float32)).to(torch.bfloat16)
    b = t(rng.normal(0, 0.3, (3 * H,)).astype(np.float32))
    from prego_tpu_torch.ops import gru_cuda

    before = gru_cuda.KERNEL.launches
    hs, hT = gru_recurrence(xg, h0, w, b)
    want_hs, want_hT = gru_recurrence_reference(xg, h0, w, b)
    assert gru_cuda.KERNEL.launches == before  # no launch for CPU tensors
    assert hs.dtype == torch.bfloat16 and hT.dtype == torch.float32
    assert torch.equal(hs, want_hs) and torch.equal(hT, want_hT)
