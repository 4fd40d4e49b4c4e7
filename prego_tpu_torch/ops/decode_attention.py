"""K2: bounded single-token decode attention (``csrc/decode_attention.cu``).

Port of prego_tpu/ops/decode_attention.py::decode_attention_bounded. The
JAX package has three Pallas bodies for it (per-row, batch-folded, and
flat head groups); they are TPU schedules of one function, and one
kernel replaces all of them here: a thread block cluster per (row, kv
head) whose blocks split the positions and merge through distributed
shared memory, one launch a call.

Semantics (the kernel's, kept by the plain version too): for each row b
and kv head g, the R query rows attend over positions t < valid[b]; masked
positions contribute nothing; valid == 0 gives zeros; p = exp(s - m) is
cast to the cache dtype before the PV product while l sums the f32 p;
out = acc / max(l, 1e-30) in q's dtype.

``valid_len`` is a Python int, a 0-d tensor or a (B,) tensor. On the card
it stays a device tensor: the wrapper never reads it back.
"""

from __future__ import annotations

from typing import Union

import torch

from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, check_cuda_tensor, stream_ptr
from prego_tpu_torch.ops.dense import bmm_f32

KERNEL = CudaKernel(
    "decode_attention",
    "decode_attention.cu",
    {"prego_decode_attention": [c_ptr] * 5 + [c_int] * 5 + [c_ptr]},
)

ValidLen = Union[int, torch.Tensor]


def _valid_vec(valid_len: ValidLen, batch: int, device) -> torch.Tensor:
    """Scalar or (B,) bound -> (B,) int32 on ``device`` (no host sync)."""
    if isinstance(valid_len, torch.Tensor):
        v = valid_len.to(device=device, dtype=torch.int32)
        return v.expand(batch).contiguous() if v.ndim == 0 else v.contiguous()
    return torch.full((batch,), int(valid_len), dtype=torch.int32, device=device)


def decode_attention_reference(
    q: torch.Tensor,  # (B, KV, R, hd)
    cache_k: torch.Tensor,  # (B, KV, T, hd)
    cache_v: torch.Tensor,
    valid_len: ValidLen,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics."""
    B, KV, R, hd = q.shape
    T = cache_k.shape[2]
    valid = _valid_vec(valid_len, B, q.device)
    s = bmm_f32(q, cache_k.transpose(-1, -2)) / (hd ** 0.5)  # (B, KV, R, T)
    mask = torch.arange(T, device=q.device)[None, None, None, :] < valid[:, None, None, None]
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # valid == 0
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = bmm_f32(p.to(cache_v.dtype), cache_v)  # (B, KV, R, hd)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len: ValidLen,
) -> torch.Tensor:
    """(B, KV, R, hd) attention output in q's dtype. CUDA: bf16 q and
    cache, R <= 8, hd <= 256 and a multiple of 16; one launch, and the
    output the only allocation where ``valid_len`` is a (B,) int32 tensor
    on the card. The kernel refuses (RuntimeError) a T whose R x ceil(T /
    C) f32 scores do not fit a block's shared memory, C <= 8 blocks a
    (row, kv head) (T past ~41,000 at R 8 and C 8)."""
    if not q.is_cuda:
        return decode_attention_reference(q, cache_k, cache_v, valid_len)
    B, KV, R, hd = q.shape
    T = cache_k.shape[2]
    check_cuda_tensor("q", q, torch.bfloat16)
    check_cuda_tensor("cache_k", cache_k, torch.bfloat16, (B, KV, T, hd))
    check_cuda_tensor("cache_v", cache_v, torch.bfloat16, (B, KV, T, hd))
    if R > 8 or hd > 256 or hd % 16:
        raise ValueError(f"decode_attention: R={R} (<= 8), hd={hd} (a multiple of 16, <= 256)")
    valid = _valid_vec(valid_len, B, q.device)
    if tuple(valid.shape) != (B,):
        raise ValueError(f"decode_attention: valid_len must be scalar or ({B},)")
    out = torch.empty_like(q)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_decode_attention",
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        B, KV, R, T, hd, stream_ptr(q.device),
    )
    return out
