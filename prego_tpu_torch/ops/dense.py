"""Matrix products with f32 results, the port's ``preferred_element_type``.

The JAX package writes ``jnp.dot(x, w, preferred_element_type=f32)``: the
operands keep their dtype and the product accumulates and returns in f32.
``mm_f32`` is that product in PyTorch: a plain f32 matmul for f32
operands; on the card a bf16 GEMM with an f32 output; on the CPU the
bf16 operands are widened exactly to f32 first.
"""

from __future__ import annotations

import torch


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) float32."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with f32 results. bf16 operands are widened exactly to
    f32 first (a product of two bf16 values is exact in f32), so the sums
    accumulate in f32 as ``preferred_element_type=f32`` asks."""
    return torch.matmul(a.float(), b.float())
