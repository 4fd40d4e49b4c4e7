"""K1: the fused GRU recurrence (``csrc/gru.cu``) and its plain version.

Port of prego_tpu/ops/gru_pallas.py: ``gru_recurrence`` is
``gru_recurrence_pallas`` (time-major xg in, hs and the carried state
out) and ``gru_layer`` is the ``gru_pallas`` wrapper around it (bulk
input projection, layout changes). The JAX dtype walk is kept: xg and
W_hh are streamed in ``stream_dtype`` (bf16 on the production path), h
is rounded to that dtype for the product with f32 accumulation, gate math
and the carried state are f32, and hs is stored in xg's dtype.

On a CUDA tensor ``gru_recurrence`` launches the kernel; on a CPU tensor
it runs ``gru_recurrence_reference``. Unlike the Pallas wrapper, nothing
is padded to a time block, so hT is always the last real frame's f32
state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
from prego_tpu_torch.ops.dense import mm_f32

KERNEL = CudaKernel(
    "gru",
    "gru.cu",
    {"prego_gru_recurrence": [c_ptr] * 8 + [c_int] * 3 + [c_ptr]},
)
# the kernel's exchange buffer, h of two frames (2, B, H) bf16, and each
# batch group's frame and exit counts (zero, and left zero), kept between
# calls
WORKSPACE = Workspace((torch.bfloat16, torch.int32), zero=(False, True))


def gru_recurrence_reference(
    xg_tm: torch.Tensor,  # (T, B, 3H), time-major
    h0: torch.Tensor,  # (B, H)
    w_hh: torch.Tensor,  # (H, 3H)
    b_hh: torch.Tensor,  # (3H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same dtype walk."""
    T, B, threeH = xg_tm.shape
    H = threeH // 3
    h = h0.float()
    b = b_hh.float()
    hs = torch.empty(T, B, H, dtype=xg_tm.dtype, device=xg_tm.device)
    for t in range(T):
        hg = mm_f32(h.to(w_hh.dtype), w_hh) + b
        x = xg_tm[t].float()
        r = torch.sigmoid(x[:, :H] + hg[:, :H])
        z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
        n = torch.tanh(x[:, 2 * H :] + r * hg[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        hs[t] = h.to(xg_tm.dtype)
    return hs, h.to(h0.dtype)


def gru_recurrence(
    xg_tm: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hs (T, B, H) in xg's dtype, hT (B, H) in h0's dtype).
    CUDA: xg and w_hh bf16, h0 and b_hh f32, all contiguous, H a multiple
    of 16."""
    if not xg_tm.is_cuda:
        return gru_recurrence_reference(xg_tm, h0, w_hh, b_hh)
    T, B, threeH = xg_tm.shape
    H = threeH // 3
    if threeH != 3 * H or H % 16 != 0:
        raise ValueError(f"gru_recurrence: 3H = {threeH} must be 3 x a multiple of 16")
    check_cuda_tensor("xg", xg_tm, torch.bfloat16)
    check_cuda_tensor("h0", h0, torch.float32, (B, H))
    check_cuda_tensor("w_hh", w_hh, torch.bfloat16, (H, threeH))
    check_cuda_tensor("b_hh", b_hh, torch.float32, (threeH,))
    hs = torch.empty(T, B, H, dtype=torch.bfloat16, device=xg_tm.device)
    hT = torch.empty(B, H, dtype=torch.float32, device=xg_tm.device)
    stream = stream_ptr(xg_tm.device)
    hbuf, counters = WORKSPACE.get(xg_tm.device, stream, 2 * B * H, 4)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_gru_recurrence",
        xg_tm.data_ptr(), h0.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
        hs.data_ptr(), hT.data_ptr(), hbuf.data_ptr(), counters.data_ptr(),
        T, B, H, stream,
    )
    return hs, hT


def gru_layer(
    x: torch.Tensor,  # (B, T, E)
    h0: torch.Tensor,  # (B, H)
    params: Dict[str, torch.Tensor],
    stream_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full GRU layer (``gru_pallas``): the input projection produced
    time-major as one product, then the fused recurrence. Returns
    (hs (B, T, H) in x's dtype, hT (B, H) in h0's dtype)."""
    xg = (mm_f32(x, params["w_ih"]) + params["b_ih"]).to(stream_dtype)
    xg = xg.transpose(0, 1).contiguous()  # time-major (T, B, 3H)
    w_hh = params["w_hh"].to(stream_dtype).contiguous()
    hs_tm, hT = gru_recurrence(
        xg, h0.float().contiguous(), w_hh, params["b_hh"].float().contiguous()
    )
    return hs_tm.transpose(0, 1).to(x.dtype), hT.to(h0.dtype)
