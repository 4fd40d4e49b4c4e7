"""The trainable GRU layer: K6's plain version against prego_tpu's
gru_bwd_pallas (interpret mode), and gru_trainable's forward and
gradients against prego_tpu's gru_trainable (interpret mode) and
jax.grad of gru_scan, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.ops.gru import gru_scan as jax_gru_scan
from prego_tpu.ops.gru import init_gru_params as jax_init_gru_params
from prego_tpu.ops.gru_pallas_vjp import gru_bwd_pallas
from prego_tpu.ops.gru_pallas_vjp import gru_trainable as jax_gru_trainable
from prego_tpu_torch.ops import gru_cuda, gru_cuda_vjp
from prego_tpu_torch.ops.gru_cuda_vjp import gru_bwd, gru_bwd_reference, gru_trainable
from tests.torch_parity import n, t

# f32 on both sides: only the summation order of the products differs
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# tests/test_gru_vjp.py's tolerances for the custom VJP against jax.grad
# of the scan: activations and dx, dh0 2e-4; weight gradients 3e-4
ACT_TOL = dict(rtol=2e-4, atol=2e-4)
W_TOL = dict(rtol=3e-4, atol=3e-4)
# bf16 streaming on both sides with the same dtype walk: the outputs round
# to bf16 alike except where an f32 sum, taken in another order, straddles
# a rounding boundary, one bf16 ulp (2^-8) of the largest value
BF16_ULP = 2.0 ** -8
# gradients of a bf16-streamed layer: those ulps enter the dh chain and the
# weight-gradient sums over T x B frames; 2^-6 of the largest value
BF16_GRAD_REL = 2.0 ** -6


def _bwd_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    return (
        rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32),  # xg
        rng.uniform(-0.9, 0.9, (T, B, H)).astype(np.float32),  # h_prev
        rng.normal(0, 0.5, (T, B, H)).astype(np.float32),  # dhs
        rng.uniform(-k, k, (H, 3 * H)).astype(np.float32),  # w_hh
        rng.uniform(-k, k, (3 * H,)).astype(np.float32),  # b_hh
    )


@pytest.mark.parametrize("T,B,H", [(16, 4, 16), (8, 3, 32), (24, 5, 8)])
def test_bwd_plain_version_matches_pallas_interpret_f32(T, B, H):
    xg, hp, dhs, w, b = _bwd_inputs(T, B, H, seed=T + B + H)
    want = gru_bwd_pallas(*(jnp.asarray(a) for a in (xg, hp, dhs, w, b)), interpret=True)
    got = gru_bwd_reference(t(xg), t(hp), t(dhs), t(w), t(b))
    for g, wt, name in zip(got, want, ("dxg", "r", "dh0")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(n(g), n(wt), **F32_TOL, err_msg=name)


@pytest.mark.parametrize("T,B,H", [(16, 4, 16), (8, 6, 48)])
def test_bwd_plain_version_matches_pallas_interpret_bf16(T, B, H):
    """The production dtype walk: xg, h_prev, dhs and W_hh in bf16."""
    xg, hp, dhs, w, b = _bwd_inputs(T, B, H, seed=T * B)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = gru_bwd_pallas(bf(xg), bf(hp), bf(dhs), bf(w), jnp.asarray(b), interpret=True)
    tb = lambda a: t(a, torch.bfloat16)
    got = gru_bwd(tb(xg), tb(hp), tb(dhs), tb(w), t(b))  # a CPU tensor: the plain version
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for g, wt, name in zip(got, want, ("dxg", "r", "dh0")):
        scale = float(np.abs(n(wt)).max())
        np.testing.assert_allclose(n(g), n(wt), rtol=0, atol=BF16_ULP * scale, err_msg=name)


def test_bwd_wrapper_takes_plain_version_on_cpu():
    args = [t(a, torch.bfloat16) for a in _bwd_inputs(5, 3, 16, seed=1)]
    args[4] = args[4].float()
    before = gru_cuda_vjp.KERNEL.launches
    got = gru_bwd(*args)
    assert gru_cuda_vjp.KERNEL.launches == before  # no launch for CPU tensors
    for g, w in zip(got, gru_bwd_reference(*args)):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def setup():
    """tests/test_gru_vjp.py's case: B 4, T 16, E 24, H 16."""
    rng = np.random.default_rng(0)
    B, T, E, H = 4, 16, 24, 16
    params = {k: np.asarray(v) for k, v in jax_init_gru_params(jax.random.PRNGKey(0), E, H).items()}
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    w = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    return x, h0, params, w


def _torch_grads(x, h0, params, loss_fn, stream=None):
    pt = {k: t(v).requires_grad_(True) for k, v in params.items()}
    xt, h0t = t(x).requires_grad_(True), t(h0).requires_grad_(True)
    hs, hT = gru_trainable(xt, h0t, pt, stream_dtype=stream)
    loss_fn(hs, hT).backward()
    return xt.grad, h0t.grad, {k: v.grad for k, v in pt.items()}


def _jax_grads(fn, x, h0, params, loss_fn):
    def loss(x, h0, p):
        hs, hT = fn(x, h0, p)
        return loss_fn(hs, hT)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(h0), jp)


def _jax_trainable(stream=None):
    return lambda x, h0, p: jax_gru_trainable(x, h0, p, 8, 64, True, stream)


def test_trainable_forward_matches(setup):
    x, h0, params, _ = setup
    want_hs, want_hT = jax_gru_trainable(
        jnp.asarray(x), jnp.asarray(h0), {k: jnp.asarray(v) for k, v in params.items()},
        8, 64, True, None,
    )
    hs, hT = gru_trainable(t(x), t(h0), {k: t(v) for k, v in params.items()}, stream_dtype=None)
    np.testing.assert_allclose(n(hs), n(want_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(hT), n(want_hT), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference", ["jax_trainable", "jax_grad_scan"])
def test_trainable_gradients_match(setup, reference):
    x, h0, params, w = setup
    jfn = _jax_trainable() if reference == "jax_trainable" else (lambda x, h0, p: jax_gru_scan(x, h0, p))
    want = _jax_grads(jfn, x, h0, params, lambda hs, hT: jnp.sum(hs * w) + 2.0 * jnp.sum(hT ** 2))
    got = _torch_grads(x, h0, params, lambda hs, hT: torch.sum(hs * t(w)) + 2.0 * torch.sum(hT ** 2))
    np.testing.assert_allclose(n(got[0]), n(want[0]), **ACT_TOL, err_msg="dx")
    np.testing.assert_allclose(n(got[1]), n(want[1]), **ACT_TOL, err_msg="dh0")
    for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
        np.testing.assert_allclose(n(got[2][k]), n(want[2][k]), **W_TOL, err_msg=k)


def test_trainable_last_frame_loss_gradients(setup):
    """The NONUNIFORM training loss shape: gradient only at the last frame."""
    x, h0, params, _ = setup
    want = _jax_grads(
        lambda x, h0, p: jax_gru_scan(x, h0, p), x, h0, params,
        lambda hs, hT: jnp.sum(jax.nn.log_softmax(hs[:, -1]) ** 2),
    )
    got = _torch_grads(x, h0, params, lambda hs, hT: torch.sum(torch.log_softmax(hs[:, -1], -1) ** 2))
    for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
        np.testing.assert_allclose(n(got[2][k]), n(want[2][k]), **W_TOL, err_msg=k)


def test_trainable_bf16_stream_matches_jax_trainable(setup):
    """The production dtype walk on both sides: xg, W_hh and h streamed in bf16."""
    x, h0, params, w = setup
    lf = lambda hs, hT: jnp.sum(hs * w) + 2.0 * jnp.sum(hT ** 2)
    want = _jax_grads(_jax_trainable(jnp.bfloat16), x, h0, params, lf)
    got = _torch_grads(x, h0, params, lambda hs, hT: torch.sum(hs * t(w)) + 2.0 * torch.sum(hT ** 2),
                       stream=torch.bfloat16)
    pairs = [(got[0], want[0]), (got[1], want[1])] + [(got[2][k], want[2][k]) for k in params]
    for g, wt in pairs:
        scale = float(np.abs(n(wt)).max())
        np.testing.assert_allclose(n(g), n(wt), rtol=0, atol=BF16_GRAD_REL * scale)


def test_trainable_odd_batch_at_large_hidden():
    """tests/test_gru_vjp.py's odd batch at H 1024 (B 24, T 8, E 32):
    forward against the scan, and gradients against jax.grad of it."""
    B, T, E, H = 24, 8, 32, 1024
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) for k, v in jax_init_gru_params(jax.random.PRNGKey(3), E, H).items()}
    x = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, H)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_hs, want_hT = jax_gru_scan(jnp.asarray(x), jnp.asarray(h0), jp)
    hs, hT = gru_trainable(t(x), t(h0), {k: t(v) for k, v in params.items()}, stream_dtype=None)
    np.testing.assert_allclose(n(hs), n(want_hs), **ACT_TOL)
    np.testing.assert_allclose(n(hT), n(want_hT), **ACT_TOL)
    lf = lambda hs, hT: (hs[:, -1] ** 2).sum()
    want = _jax_grads(lambda x, h0, p: jax_gru_scan(x, h0, p), x, h0, params, lf)
    got = _torch_grads(x, h0, params, lf)
    np.testing.assert_allclose(n(got[0]), n(want[0]), **ACT_TOL, err_msg="dx")
    for k in ("w_ih", "b_ih", "w_hh", "b_hh"):
        np.testing.assert_allclose(n(got[2][k]), n(want[2][k]), **W_TOL, err_msg=k)


def test_trainable_takes_plain_versions_on_cpu(setup):
    x, h0, params, w = setup
    k1, k6 = gru_cuda.KERNEL.launches, gru_cuda_vjp.KERNEL.launches
    _torch_grads(x, h0, params, lambda hs, hT: torch.sum(hs * t(w)), stream=torch.bfloat16)
    assert (gru_cuda.KERNEL.launches, gru_cuda_vjp.KERNEL.launches) == (k1, k6)
