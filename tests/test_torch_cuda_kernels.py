"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax, so it runs on a machine that has only PyTorch:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py sets up jax for the parity
tests.) Inputs are made with numpy from a seed and compared in bf16, the
kernels' working type.
"""

import numpy as np
import pytest
import torch

from prego_tpu_torch.ops import decode_attention as da
from prego_tpu_torch.ops import fused_ffn as ffn
from prego_tpu_torch.ops import gru_cuda, gru_cuda_vjp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # decided at run time, inside the test: skip where there is no card
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


# GRU: identical bf16 roundings except where an f32 sum of H products,
# taken in another order, straddles a bf16 boundary of h: one bf16 ulp
# (2^-8 relative, |h| < 1) carried on by the recurrence
GRU_TOL = dict(rtol=0, atol=2.0 ** -6)
# GRU backward: r depends only on h_prev and xg, so it differs by the
# f32 summation order of h_prev.W_hh, at most one bf16 ulp (2^-8, r < 1).
# dxg and dh carry the dh chain: where an f32 sum straddles a bf16 boundary
# of dHG = [da, db, dc r], one bf16 ulp of dHG (2^-8 relative) enters dh and
# the chain carries it on, contracted by z and W_hh each frame; measured
# against the largest value, 2^-6 bounds it over these T
GRU_BWD_R_TOL = 2.0 ** -7
GRU_BWD_REL_TOL = 2.0 ** -6
# decode attention: p is rounded to bf16 against the split's own max, not
# the row's; each p_t moves by at most 2^-9 relative, the output (a convex
# combination of |v| < 5) by 2^-9 * 5, plus its own bf16 rounding
ATTN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -6)
# fused FFN: the bf16 output rounds h + y; sums of F products in another
# order can round one bf16 ulp apart, 2^-5 at |out| < 8
FFN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -5)


def _gru_inputs(device, T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    xg = torch.from_numpy(rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(0, 0.5, (B, H)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-k, k, (H, 3 * H)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-k, k, (3 * H,)).astype(np.float32))
    return (xg.to(device, torch.bfloat16), h0.to(device), w.to(device, torch.bfloat16),
            b.to(device))


@pytest.mark.parametrize("T,B,H", [(1, 1, 16), (9, 3, 48), (40, 17, 256), (5, 100, 64),
                                   (64, 64, 1024)])
def test_gru_kernel_matches_plain(cuda_device, T, B, H):
    xg, h0, w, b = _gru_inputs(cuda_device, T, B, H)
    before = gru_cuda.KERNEL.launches
    hs, hT = gru_cuda.gru_recurrence(xg, h0, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.KERNEL.launches == before + 1
    want_hs, want_hT = gru_cuda.gru_recurrence_reference(xg, h0, w, b)
    torch.testing.assert_close(hs.float(), want_hs.float(), **GRU_TOL)
    torch.testing.assert_close(hT, want_hT, **GRU_TOL)


def _attn_inputs(device, B, KV, R, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        device, torch.bfloat16)
    return mk(B, KV, R, hd), mk(B, KV, T, hd), mk(B, KV, T, hd)


@pytest.mark.parametrize("B,KV,R,T,hd", [(2, 2, 1, 128, 128), (3, 4, 2, 192, 64),
                                         (8, 32, 1, 512, 128), (2, 8, 4, 512, 128)])
def test_decode_attention_kernel_matches_plain(cuda_device, B, KV, R, T, hd):
    q, k, v = _attn_inputs(cuda_device, B, KV, R, T, hd)
    valid = torch.tensor(([0, T, 1, 77, 64, 65, 300, 511] * B)[:B], dtype=torch.int32,
                         device=cuda_device).clamp(max=T)
    out = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    want = da.decode_attention_reference(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL)
    assert torch.all(out[valid == 0] == 0)
    # a scalar bound reaches the same kernel
    torch.testing.assert_close(
        da.decode_attention(q, k, v, T // 2).float(),
        da.decode_attention_reference(q, k, v, T // 2).float(), **ATTN_TOL)


def _ffn_inputs(device, M, D, F, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, *shape: torch.from_numpy(
        (rng.normal(0, 1, shape) * s).astype(np.float32)).to(device, torch.bfloat16)
    return (mk(1.0, M, D), mk(0.1, D) + 1, mk(D ** -0.5, D, 2 * F), mk(F ** -0.5, F, D))


@pytest.mark.parametrize("M,D,F", [(1, 64, 176), (3, 256, 512), (8, 512, 1000),
                                   (1, 4096, 11008), (8, 4096, 11008)])
def test_fused_ffn_kernel_matches_plain(cuda_device, M, D, F):
    h, nw, w13, w2 = _ffn_inputs(cuda_device, M, D, F)
    out = ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)
    torch.cuda.synchronize()
    want = ffn.fused_ffn_block_reference(h, nw, w13, w2, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), **FFN_TOL)


def test_kernels_refuse_what_they_cannot_take(cuda_device):
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 9, 64, 176)
    with pytest.raises(ValueError):
        ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)  # M above the decode bound
    with pytest.raises(ValueError):
        ffn.fused_ffn_block(h.view(-1)[1:65].view(1, 64), nw, w13, w2, 1e-5)  # misaligned rows
    q, k, v = _attn_inputs(cuda_device, 1, 1, 1, 64, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q.float(), k.float(), v.float(), 3)  # f32 cache
    xg, h0, w, b = _gru_inputs(cuda_device, 2, 2, 16)
    with pytest.raises(ValueError):
        gru_cuda.gru_recurrence(xg, h0.to(torch.bfloat16), w, b)  # bf16 state
    xg, h0, w, b = _gru_inputs(cuda_device, 2, 2, 24)
    with pytest.raises(ValueError):
        gru_cuda.gru_recurrence(xg, h0, w, b)  # H not a multiple of 16


def _gru_bwd_inputs(device, T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    mk = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return (
        mk(rng.normal(0, 1, (T, B, 3 * H))),  # xg
        mk(rng.uniform(-0.9, 0.9, (T, B, H))),  # h_prev
        mk(rng.normal(0, 0.5, (T, B, H))),  # dhs
        mk(rng.uniform(-k, k, (H, 3 * H))),  # w_hh
        torch.from_numpy(rng.uniform(-k, k, (3 * H,)).astype(np.float32)).to(device),
    )


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("T,B,H", [(1, 1, 16), (9, 3, 48), (13, 17, 256), (7, 100, 64),
                                   (20, 64, 1024), (128, 16, 1024)])
def test_gru_bwd_kernel_matches_plain(cuda_device, T, B, H):
    args = _gru_bwd_inputs(cuda_device, T, B, H)
    before = gru_cuda_vjp.KERNEL.launches
    dxg, r, dh0 = gru_cuda_vjp.gru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_cuda_vjp.KERNEL.launches == before + 1
    assert dxg.dtype == r.dtype == torch.bfloat16 and dh0.dtype == torch.float32
    want_dxg, want_r, want_dh0 = gru_cuda_vjp.gru_bwd_reference(*args)
    assert float((r.float() - want_r.float()).abs().max()) <= GRU_BWD_R_TOL
    assert _rel_err(dxg, want_dxg) <= GRU_BWD_REL_TOL
    assert _rel_err(dh0, want_dh0) <= GRU_BWD_REL_TOL


def test_gru_bwd_kernel_is_deterministic(cuda_device):
    args = _gru_bwd_inputs(cuda_device, 33, 24, 1024, seed=2)
    first = gru_cuda_vjp.gru_bwd(*args)
    second = gru_cuda_vjp.gru_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_bwd_kernel_refuses_what_it_cannot_take(cuda_device):
    with pytest.raises(ValueError):
        gru_cuda_vjp.gru_bwd(*_gru_bwd_inputs(cuda_device, 2, 2, 24))  # H not a multiple of 16
    xg, hp, dhs, w, b = _gru_bwd_inputs(cuda_device, 2, 2, 16)
    with pytest.raises(ValueError):
        gru_cuda_vjp.gru_bwd(xg, hp.float(), dhs, w, b)  # f32 h_prev
    with pytest.raises(RuntimeError):
        # 256 CTAs of 8 units, each holding 200 KB of W_hh: not resident at once
        gru_cuda_vjp.gru_bwd(*_gru_bwd_inputs(cuda_device, 2, 2, 2048))


def test_gru_trainable_runs_k1_forward_and_k6_backward(cuda_device):
    """The layer's gradients on the card (bf16 stream) against its f32
    plain path on the CPU: bf16 streaming of x.W_ih, W_hh and h moves
    every gradient by a few bf16 ulps of its largest value."""
    B, T, E, H = 8, 24, 64, 256
    rng = np.random.default_rng(4)
    k = 1 / np.sqrt(H)
    p = {"w_ih": rng.uniform(-k, k, (E, 3 * H)), "b_ih": rng.uniform(-k, k, (3 * H,)),
         "w_hh": rng.uniform(-k, k, (H, 3 * H)), "b_hh": rng.uniform(-k, k, (3 * H,))}
    x = rng.normal(0, 1, (B, T, E))
    w = rng.normal(0, 1, (B, T, H))

    def grads(device, stream):
        pt = {n: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
              for n, v in p.items()}
        xt = torch.tensor(x, dtype=torch.float32, device=device, requires_grad=True)
        h0 = torch.zeros(B, H, device=device, requires_grad=True)
        hs, hT = gru_cuda_vjp.gru_trainable(xt, h0, pt, stream_dtype=stream)
        (torch.sum(hs * torch.tensor(w, dtype=torch.float32, device=device))
         + 2.0 * torch.sum(hT ** 2)).backward()
        return [t.grad.cpu() for t in (xt, h0, *pt.values())]

    k1, k6 = gru_cuda.KERNEL.launches, gru_cuda_vjp.KERNEL.launches
    got = grads(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    assert gru_cuda.KERNEL.launches == k1 + 1 and gru_cuda_vjp.KERNEL.launches == k6 + 1
    want = grads("cpu", torch.float32)
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= 2.0 ** -4
