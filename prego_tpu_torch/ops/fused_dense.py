"""K9: the int8 projection with an rms_norm prologue or a residual
epilogue, in CUDA (``csrc/fused_dense_q8.cu``).

Port of prego_tpu/ops/fused_dense.py::fused_dense_q8, which removes the
remaining op boundaries of the int8 decode layer:

  norm mode      rms_norm(x, norm_weight) @ deq(q), cast to ``out_dtype``
                 (default f32): the fused qkv and the lm-head
  residual mode  residual + (x @ deq(q)).astype(residual.dtype): wo

Exactly one of ``norm_weight`` and ``residual`` is given. The numerics are
the unfused sequence's: ``rms_norm``'s dtype walk (f32 statistics, the
normed value cast to x's dtype, then scaled by the weight), then K4's
convention (bf16 operands, f32 products and sums, the column scale after
the sum), then the cast or the residual add in the residual's dtype.

On a CUDA tensor the wrapper launches the kernel (bf16 x, any number of
rows: K4's streaming loop up to 8, in norm mode with the norm in its
prologue at some row counts; K4's tensor-core tiles above) or raises; on a CPU tensor it
runs ``fused_dense_q8_reference``. A call allocates its output alone: the
kernel's partial sums and normed rows live in a workspace kept per
(device, stream).
"""

from __future__ import annotations

from typing import Optional

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_float, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
from prego_tpu_torch.ops.fused_ffn import rms_norm
from prego_tpu_torch.ops.quant import int8_matmul_reference

KERNEL = CudaKernel(
    "fused_dense_q8",
    "fused_dense_q8.cu",
    {
        "prego_fused_dense_q8": [c_ptr] * 8 + [c_int] * 5 + [c_float, c_ptr],
        "prego_fused_dense_q8_splits": [c_int] * 3,
    },
)

# f32 partial sums (splits x M x N; the tile path's scaled y) and the normed
# rows (M x K bf16) of the norm launch
WORKSPACE = Workspace((torch.float32, torch.bfloat16))


def _check_mode(norm_weight, residual) -> None:
    if (norm_weight is None) == (residual is None):
        raise ValueError("fused_dense_q8: give exactly one of norm_weight and residual")


def fused_dense_q8_reference(
    x: torch.Tensor,
    q: torch.Tensor,
    scale: torch.Tensor,
    *,
    norm_weight: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K9: the unfused sequence it replaces."""
    _check_mode(norm_weight, residual)
    if residual is not None:
        return residual + int8_matmul_reference(x, q, scale).to(residual.dtype)
    y = int8_matmul_reference(rms_norm(x, norm_weight, eps), q, scale)
    return y.to(torch.float32 if out_dtype is None else out_dtype)


def fused_dense_q8(
    x: torch.Tensor,  # (M, K)
    q: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (1, N) f32
    *,
    norm_weight: Optional[torch.Tensor] = None,  # (K,)
    residual: Optional[torch.Tensor] = None,  # (M, N)
    eps: float = 1e-5,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(M, N): ``rms_norm(x) @ deq(q)`` in ``out_dtype`` (f32 by default), or
    ``residual + (x @ deq(q))`` in the residual's dtype. CUDA: bf16 x (and
    norm weight, residual), K and N multiples of 8; out_dtype bf16 or f32."""
    _check_mode(norm_weight, residual)
    if not x.is_cuda:
        return fused_dense_q8_reference(x, q, scale, norm_weight=norm_weight, residual=residual,
                                        eps=eps, out_dtype=out_dtype)
    M, K = x.shape
    N = q.shape[1]
    check_cuda_tensor("x", x, torch.bfloat16, (M, K))
    check_cuda_tensor("q", q, torch.int8, (K, N))
    check_cuda_tensor("scale", scale, torch.float32, (1, N))
    if M < 1 or K % 8 or N % 8:
        raise ValueError(f"fused_dense_q8: M={M} K={K} N={N} (K and N multiples of 8)")
    if residual is not None:
        check_cuda_tensor("residual", residual, torch.bfloat16, (M, N))
        out_dtype = torch.bfloat16
    else:
        check_cuda_tensor("norm_weight", norm_weight, torch.bfloat16, (K,))
        out_dtype = torch.float32 if out_dtype is None else out_dtype
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"fused_dense_q8: out_dtype {out_dtype} (f32 or bf16)")
    splits = KERNEL.lib().prego_fused_dense_q8_splits(M, K, N)  # 0: the tile path (M > 8)
    sizes = (splits * M * N if splits else M * N if out_dtype == torch.bfloat16 else 0,
             M * K if residual is None else 0)
    stream = stream_ptr(x.device)
    part, xn = WORKSPACE.get(x.device, stream, *sizes)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_fused_dense_q8",
        x.data_ptr(), 0 if norm_weight is None else norm_weight.data_ptr(),
        0 if residual is None else residual.data_ptr(), q.data_ptr(), scale.data_ptr(),
        xn.data_ptr(), part.data_ptr(), out.data_ptr(),
        M, K, N, splits, int(out_dtype == torch.bfloat16), float(eps), stream,
    )
    return out
