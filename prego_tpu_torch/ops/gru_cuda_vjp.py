"""The trainable GRU layer: K1 forward, K6 reverse-time backward
(``csrc/gru_bwd.cu``), and the plain version of K6.

Port of prego_tpu/ops/gru_pallas_vjp.py. ``gru_bwd`` is
``gru_bwd_pallas``: the reverse-time recurrence that carries the dh chain
and emits per-frame pre-activation gradients dXG = [da, db, dc] and the
recomputed reset gate R. ``GruTrainable`` is the ``jax.custom_vjp`` around
it: the forward is ``gru_layer``'s path (K1 on the card), saves hs in the
stream dtype and recomputes xg in the backward instead of saving it; the
backward folds dhT into the last frame, runs K6, then forms

  dW_hh = sum_t h_{t-1}^T dHG_t,  dHG = dXG with its n-slice scaled by R
  dW_ih = x^T dXG,  dx = dXG W_ih^T,  the biases as sums

as plain products, as the JAX package leaves them to XLA outside the
kernel. Gradient math per step (r = sigmoid(a), z = sigmoid(b),
n = tanh(c), c = xn + r hn):

  dz = G (h_prev - n), db = dz z (1 - z), dn = G (1 - z),
  dc = dn (1 - n^2), da = dc hn r (1 - r), dh_prev = G z + [da, db, dc r] W_hh^T.

The JAX dtype walk is kept: xg, h_prev, dhs and W_hh stream in
``stream_dtype`` (bf16 on the card), gate math and the dh chain are f32,
dxg and r leave in xg's dtype. Unlike the TPU kernel, which writes dxg
over xg and r over dhs to fit VMEM, the wrapper allocates its outputs: the
card has the memory, and the caller's buffers stay intact. The TPU's time
and batch tilings (``time_block``, ``batch_block``, ``_fit_batch_block``)
have no counterpart. On a CUDA tensor ``gru_bwd`` launches the kernel or
raises; on a CPU tensor it runs ``gru_bwd_reference``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, check_cuda_tensor, stream_ptr
from prego_tpu_torch.ops.dense import mm_f32
from prego_tpu_torch.ops.gru_cuda import gru_recurrence

KERNEL = CudaKernel(
    "gru_bwd",
    "gru_bwd.cu",
    {"prego_gru_bwd": [c_ptr] * 9 + [c_int] * 3 + [c_ptr]},
)


def gru_bwd_reference(
    xg_tm: torch.Tensor,  # (T, B, 3H) time-major input gates
    hprev_tm: torch.Tensor,  # (T, B, H) h_{t-1} per frame (h0 at t = 0)
    dhs_tm: torch.Tensor,  # (T, B, H) upstream gradients
    w_hh: torch.Tensor,  # (H, 3H)
    b_hh: torch.Tensor,  # (3H,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same dtype walk."""
    T, B, threeH = xg_tm.shape
    H = threeH // 3
    b = b_hh.float()
    dh = torch.zeros(B, H, dtype=torch.float32, device=xg_tm.device)
    dxg = torch.empty(T, B, threeH, dtype=xg_tm.dtype, device=xg_tm.device)
    r_out = torch.empty(T, B, H, dtype=xg_tm.dtype, device=xg_tm.device)
    for i in reversed(range(T)):
        h_prev = hprev_tm[i].float()
        hg = mm_f32(h_prev.to(w_hh.dtype), w_hh) + b
        x = xg_tm[i].float()
        r = torch.sigmoid(x[:, :H] + hg[:, :H])
        z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
        hn = hg[:, 2 * H :]
        n = torch.tanh(x[:, 2 * H :] + r * hn)
        G = dhs_tm[i].float() + dh
        dz = G * (h_prev - n)
        db = dz * z * (1.0 - z)
        dn = G * (1.0 - z)
        dc = dn * (1.0 - n * n)
        da = dc * hn * r * (1.0 - r)
        dhg = torch.cat([da, db, dc * r], dim=-1)
        dh = G * z + mm_f32(dhg.to(w_hh.dtype), w_hh.t())
        dxg[i] = torch.cat([da, db, dc], dim=-1).to(dxg.dtype)
        r_out[i] = r.to(r_out.dtype)
    return dxg, r_out, dh


def gru_bwd(
    xg_tm: torch.Tensor, hprev_tm: torch.Tensor, dhs_tm: torch.Tensor,
    w_hh: torch.Tensor, b_hh: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dxg (T, B, 3H) and r (T, B, H) in xg's dtype, dh0 (B, H)
    f32). CUDA: xg, hprev, dhs and w_hh bf16, b_hh f32, all contiguous, H a
    multiple of 16 and at most what the card holds resident (1024 on an
    H100)."""
    if not xg_tm.is_cuda:
        return gru_bwd_reference(xg_tm, hprev_tm, dhs_tm, w_hh, b_hh)
    T, B, threeH = xg_tm.shape
    H = threeH // 3
    if threeH != 3 * H or H % 16 != 0:
        raise ValueError(f"gru_bwd: 3H = {threeH} must be 3 x a multiple of 16")
    check_cuda_tensor("xg", xg_tm, torch.bfloat16)
    check_cuda_tensor("hprev", hprev_tm, torch.bfloat16, (T, B, H))
    check_cuda_tensor("dhs", dhs_tm, torch.bfloat16, (T, B, H))
    check_cuda_tensor("w_hh", w_hh, torch.bfloat16, (H, threeH))
    check_cuda_tensor("b_hh", b_hh, torch.float32, (threeH,))
    dev = xg_tm.device
    dxg = torch.empty(T, B, threeH, dtype=torch.bfloat16, device=dev)
    r = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    dh0 = torch.empty(B, H, dtype=torch.float32, device=dev)
    gbuf = torch.empty(2, B, threeH, dtype=torch.bfloat16, device=dev)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_gru_bwd",
        xg_tm.data_ptr(), hprev_tm.data_ptr(), dhs_tm.data_ptr(), w_hh.data_ptr(),
        b_hh.data_ptr(), dxg.data_ptr(), r.data_ptr(), dh0.data_ptr(), gbuf.data_ptr(),
        T, B, H, stream_ptr(dev),
    )
    return dxg, r, dh0


def _input_gates(x, w_ih, b_ih, stream):
    """xg = x.W_ih + b_ih, time-major (T, B, 3H), in the stream dtype."""
    return (mm_f32(x, w_ih) + b_ih).to(stream).transpose(0, 1).contiguous()


class GruTrainable(torch.autograd.Function):
    """Differentiable fused GRU layer: (x (B, T, E), h0 (B, H), weights)
    -> (hs (B, T, H), hT (B, H))."""

    @staticmethod
    def forward(ctx, x, h0, w_ih, b_ih, w_hh, b_hh, stream):
        xg = _input_gates(x, w_ih, b_ih, stream)
        hs_tm, hT = gru_recurrence(
            xg, h0.float().contiguous(), w_hh.to(stream).contiguous(), b_hh.float().contiguous()
        )
        ctx.stream = stream
        ctx.save_for_backward(x, h0, w_ih, b_ih, w_hh, b_hh, hs_tm)
        return hs_tm.transpose(0, 1).to(x.dtype), hT.to(h0.dtype)

    @staticmethod
    def backward(ctx, dhs, dhT):
        x, h0, w_ih, b_ih, w_hh, b_hh, hs_tm = ctx.saved_tensors
        stream = ctx.stream
        B, T, E = x.shape
        H = h0.shape[-1]
        # fold the final-state cotangent into the last frame (hT == hs[:, -1])
        dhs = dhs.clone()
        dhs[:, -1] += dhT.to(dhs.dtype)
        dhs_tm = dhs.transpose(0, 1).to(stream).contiguous()
        # recompute xg (one product) instead of saving (T, B, 3H) residuals
        xg_tm = _input_gates(x, w_ih, b_ih, stream)
        hprev_tm = torch.cat([h0[None].to(stream), hs_tm[:-1].to(stream)], dim=0).contiguous()
        dxg_tm, r_tm, dh0 = gru_bwd(
            xg_tm, hprev_tm, dhs_tm, w_hh.to(stream).contiguous(), b_hh.float().contiguous()
        )
        dxg = dxg_tm.float().reshape(T * B, 3 * H)
        dhg = torch.cat(
            [dxg[:, : 2 * H], dxg[:, 2 * H :] * r_tm.float().reshape(T * B, H)], dim=-1
        )
        hprev_f = hprev_tm.float().reshape(T * B, H)
        x_tm = x.float().transpose(0, 1).reshape(T * B, E)
        d_w_hh = hprev_f.t() @ dhg
        d_w_ih = x_tm.t() @ dxg
        dx = (dxg @ w_ih.float().t()).reshape(T, B, E).transpose(0, 1)
        return (
            dx.to(x.dtype), dh0.to(h0.dtype),
            d_w_ih.to(w_ih.dtype), dxg.sum(0).to(b_ih.dtype),
            d_w_hh.to(w_hh.dtype), dhg.sum(0).to(b_hh.dtype), None,
        )


def gru_trainable(
    x: torch.Tensor,  # (B, T, E)
    h0: torch.Tensor,  # (B, H)
    params: Dict[str, torch.Tensor],
    stream_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused GRU layer; ``stream_dtype`` None streams in x's
    dtype (the f32 parity path on the CPU). Returns (hs (B, T, H), hT (B, H))."""
    stream = stream_dtype or x.dtype
    return GruTrainable.apply(
        x, h0, params["w_ih"], params["b_ih"], params["w_hh"], params["b_hh"], stream
    )
