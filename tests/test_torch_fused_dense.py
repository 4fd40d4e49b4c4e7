"""K9 parity: the port's plain version of fused_dense_q8 (the int8
projection with an rms_norm prologue or a residual epilogue) against
prego_tpu's fused_dense_q8 in interpret mode, and against the port's own
unfused sequence, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.fused_dense import fused_dense_q8 as jax_fused_dense_q8
from prego_tpu.ops.quant import quantize_weight as jax_quantize_weight
from prego_tpu_torch.ops import fused_dense as port
from prego_tpu_torch.ops.fused_ffn import rms_norm
from prego_tpu_torch.ops.quant import int8_matmul
from tests.torch_parity import n, t

# the JAX package's bar for this kernel against the unfused sequence
# (tests/test_fused_dense.py): both sides cast x to bf16 and sum exact
# products in f32, in another order
TOL = dict(rtol=2e-3, atol=2e-3)
EPS = 1e-5
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    q, s = jax_quantize_weight(jnp.asarray(w))
    nw = rng.normal(1, 0.1, (K,)).astype(np.float32)
    res = rng.normal(0, 1, (M, N)).astype(np.float32)
    return x, np.asarray(q), np.asarray(s), nw, res


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("mode", ["norm", "residual"])
def test_matches_pallas_interpret(mode, M, dtype):
    K, N = (128, 384) if mode == "norm" else (256, 192)
    x, q, s, nw, res = _inputs(M * 31 + K, M, K, N)
    _, jdt, tdt = DTYPES[dtype]
    jx, tx = jnp.asarray(x).astype(jdt), t(x, tdt)
    if mode == "norm":  # out in the stream's dtype, as the qkv call site asks
        want = jax_fused_dense_q8(jx, jnp.asarray(q), jnp.asarray(s),
                                  norm_weight=jnp.asarray(nw).astype(jdt), eps=EPS,
                                  out_dtype=jdt, interpret=True)
        got = port.fused_dense_q8(tx, t(q), t(s), norm_weight=t(nw, tdt), eps=EPS, out_dtype=tdt)
    else:
        want = jax_fused_dense_q8(jx, jnp.asarray(q), jnp.asarray(s),
                                  residual=jnp.asarray(res).astype(jdt), interpret=True)
        got = port.fused_dense_q8(tx, t(q), t(s), residual=t(res, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_lm_head_default_is_f32():
    """Without out_dtype the norm mode returns f32, as the lm-head site
    takes it (the JAX default)."""
    x, q, s, nw, _ = _inputs(5, 4, 64, 96)
    want = jax_fused_dense_q8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
                              norm_weight=jnp.asarray(nw, jnp.bfloat16), eps=EPS,
                              interpret=True)
    got = port.fused_dense_q8(t(x, torch.bfloat16), t(q), t(s), norm_weight=t(nw, torch.bfloat16),
                              eps=EPS)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_unfused_sequence(dtype):
    """The plain version computes the op sequence K9 replaces, bit for bit:
    rms_norm, K4, cast (norm mode); K4, cast, add (residual mode)."""
    x, q, s, nw, res = _inputs(9, 3, 128, 64)
    tx, tq, ts = t(x, dtype), t(q), t(s)
    normed = port.fused_dense_q8(tx, tq, ts, norm_weight=t(nw, dtype), eps=EPS, out_dtype=dtype)
    assert torch.equal(normed, int8_matmul(rms_norm(tx, t(nw, dtype), EPS), tq, ts).to(dtype))
    added = port.fused_dense_q8(tx, tq, ts, residual=t(res[:, :64], dtype))
    assert torch.equal(added, t(res[:, :64], dtype) + int8_matmul(tx, tq, ts).to(dtype))


@pytest.mark.parametrize("both", [True, False])
def test_exactly_one_mode_required(both):
    x, q, s, nw, res = _inputs(0, 2, 64, 64)
    kw = dict(norm_weight=t(nw), residual=t(res)) if both else {}
    with pytest.raises(ValueError, match="exactly one"):
        port.fused_dense_q8(t(x), t(q), t(s), **kw)
    with pytest.raises(ValueError, match="exactly one"):
        port.fused_dense_q8_reference(t(x), t(q), t(s), **kw)


def test_wrapper_takes_plain_version_on_cpu():
    x, q, s, nw, res = _inputs(1, 2, 64, 128)
    before = port.KERNEL.launches
    out = port.fused_dense_q8(t(x), t(q), t(s), residual=t(res))
    assert port.KERNEL.launches == before
    assert torch.equal(out, port.fused_dense_q8_reference(t(x), t(q), t(s), residual=t(res)))
