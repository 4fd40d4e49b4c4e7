"""K4 and K5: int8 serving matmuls in CUDA (``csrc/int8_matmul.cu``).

Port of prego_tpu/ops/quant.py. Quantization is symmetric int8:

  quantize_weight:       W (K, N) -> int8 q (K, N), f32 scale (1, N),
                         scale_j = max(max|W[:, j]|, 1e-8) / 127
  quantize_activations:  x (M, K) -> int8 xq (M, K), f32 scale (M, 1), per row
  int8_matmul (K4):      y = (bf16(x) . bf16(q)) * s, f32 accumulation
  int8xint8_matmul (K5): y = float(xq . q in int32) * x_scale * s

Values round half to even and clip at +-127, as ``jnp.round`` and
``jnp.clip`` do. The matmuls return (M, N) f32. On a CUDA tensor the
wrappers launch the kernel or raise; on a CPU tensor they run the plain
versions below. The TPU package's tile rules (``_pick_n_block``,
``_fit_blocks``, ``PREGO_Q8_NBLOCK``) size VMEM windows and have no
counterpart here: the kernel picks its own tiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
from prego_tpu_torch.ops.dense import mm_f32

KERNEL_W8 = CudaKernel(
    "int8_matmul",
    "int8_matmul.cu",
    {
        "prego_int8_matmul": [c_ptr] * 4 + [c_int] * 4 + [c_ptr],
        "prego_int8_matmul_splits": [c_int] * 3,
    },
)
# K5 lives in the same source; its own entry keeps its own launch count
KERNEL_W8A8 = CudaKernel(
    "int8xint8_matmul",
    "int8_matmul.cu",
    {
        "prego_int8xint8_matmul": [c_ptr] * 7 + [c_int] * 4 + [c_ptr],
        "prego_int8xint8_matmul_splits": [c_int] * 3,
    },
)
GEMV_TILE_N = 128  # output columns of a streaming block (csrc/w8_matmul.cuh kTileN)
# K5's streaming path: int32 sums (M x N) and a ticket per column tile
W8A8_WORKSPACE = Workspace(torch.int32, zero=True)


def _quantize(xf: torch.Tensor, dim: int, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if amax is None:
        amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. w: (K, N) -> (q, scale (1, N))."""
    return _quantize(w.float(), 0)


def quantize_activations(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8. x: (M, K) -> (xq, scale (M, 1));
    ``amax`` (M, 1) in place of x's own per-row max |x| (a row split over
    ranks takes the max over all of them)."""
    return _quantize(x.float(), -1, amax)


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: bf16 operands, f32 products and sums, then the
    per-channel scale."""
    return mm_f32(x.to(torch.bfloat16), q.to(torch.bfloat16)) * scale[0]


def int8xint8_matmul_reference(
    xq: torch.Tensor, x_scale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of K5. The int8 products summed in float64 are the
    exact int32 sum (|sum| < 2^31 < 2^53), rounded once to f32 as the
    int32 -> f32 conversion rounds; then x_scale, then the channel scale."""
    acc = torch.matmul(xq.double(), q.double()).float()
    return acc * x_scale * scale[0]


def _check_weight(q: torch.Tensor, scale: torch.Tensor, K: int):
    N = q.shape[1]
    check_cuda_tensor("q", q, torch.int8, (K, N))
    check_cuda_tensor("scale", scale, torch.float32, (1, N))
    return N


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N) int8, scale (1, N) f32) -> (M, N) f32.
    x is cast to bf16 first. CUDA: K a multiple of 8, N a multiple of 8; one
    launch, and out the only allocation."""
    if not x.is_cuda:
        return int8_matmul_reference(x, q, scale)
    M, K = x.shape
    x = x.to(torch.bfloat16).contiguous()
    check_cuda_tensor("x", x, torch.bfloat16, (M, K))
    N = _check_weight(q, scale, K)
    if M < 1 or K % 8 or N % 8:
        raise ValueError(f"int8_matmul: M={M} K={K} N={N} (K and N multiples of 8)")
    splits = KERNEL_W8.lib().prego_int8_matmul_splits(M, K, N)  # 0: the tile path
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    KERNEL_W8.launches += 1
    KERNEL_W8.call(
        "prego_int8_matmul", x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, splits, stream_ptr(x.device),
    )
    return out


def int8xint8_matmul(
    xq: torch.Tensor, x_scale: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """dequant(xq (M, K) int8, x_scale (M, 1)) @ dequant(q, scale) ->
    (M, N) f32, int32 accumulation. CUDA: K a multiple of 16, N of 8; one
    launch, and out the only allocation once the streaming workspace (M <=
    8) is as large as the call needs. Calls on one stream share that
    workspace in stream order."""
    if not xq.is_cuda:
        return int8xint8_matmul_reference(xq, x_scale, q, scale)
    M, K = xq.shape
    check_cuda_tensor("xq", xq, torch.int8, (M, K))
    check_cuda_tensor("x_scale", x_scale, torch.float32, (M, 1))
    N = _check_weight(q, scale, K)
    if M < 1 or K % 16 or N % 8:
        raise ValueError(f"int8xint8_matmul: M={M} K={K} N={N} (K a multiple of 16, N of 8)")
    splits = KERNEL_W8A8.lib().prego_int8xint8_matmul_splits(M, K, N)  # 0: the tile path
    stream = stream_ptr(xq.device)
    ws = tickets = None
    if splits:
        ws, tickets = W8A8_WORKSPACE.get(xq.device, stream, M * N, -(-N // GEMV_TILE_N))
    out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
    KERNEL_W8A8.launches += 1
    KERNEL_W8A8.call(
        "prego_int8xint8_matmul", xq.data_ptr(), x_scale.data_ptr(), q.data_ptr(),
        scale.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(), M, K, N, splits, stream,
    )
    return out
