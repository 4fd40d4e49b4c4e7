"""K3: bounded single-token decode attention over an int8 KV cache
(``csrc/decode_attention_q8.cu``).

Port of prego_tpu/ops/decode_attention.py::decode_attention_bounded_q8 in
its default mode (the model never passes ``int8_mxu=True``; that mode is
not ported, ROADMAP). Its batch-folded and flat-head Pallas bodies are TPU
schedules of the same function and have no port of their own, as with K2.

The cache leaves are int8 values (B, KV, T, hd) with one f32 scale per
(row, head, position), (B, KV, T). Semantics, kept by the plain version
too: q is rounded to bf16 and dotted with the int8 keys (exact products,
f32 sums), then multiplied by the key scale and 1/sqrt(hd); positions at
or past ``valid`` are masked and their p set to 0; l sums the f32 p;
``p * v_scale`` is rounded to bf16 before the product with the int8
values; out = acc / max(l, 1e-30) in q's dtype; valid == 0 gives zeros.
"""

from __future__ import annotations

import torch

from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, check_cuda_tensor, stream_ptr
from prego_tpu_torch.ops.decode_attention import ValidLen, _valid_vec
from prego_tpu_torch.ops.dense import bmm_f32

KERNEL = CudaKernel(
    "decode_attention_q8",
    "decode_attention_q8.cu",
    {
        "prego_decode_attention_q8": [c_ptr] * 9 + [c_int] * 5 + [c_ptr],
        "prego_decode_attention_q8_splits": [c_int],
    },
)


def decode_attention_q8_reference(
    q: torch.Tensor,  # (B, KV, R, hd)
    kq: torch.Tensor,  # (B, KV, T, hd) int8
    ks: torch.Tensor,  # (B, KV, T) f32
    vq: torch.Tensor,
    vs: torch.Tensor,
    valid_len: ValidLen,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same roundings; pv is rounded
    against the row's max (the kernel: against its split's)."""
    B, KV, R, hd = q.shape
    T = kq.shape[2]
    valid = _valid_vec(valid_len, B, q.device)
    bf16 = torch.bfloat16
    s = bmm_f32(q.to(bf16), kq.to(bf16).transpose(-1, -2))  # (B, KV, R, T)
    s = s * ks[:, :, None, :] * (hd ** -0.5)
    mask = torch.arange(T, device=q.device)[None, None, None, :] < valid[:, None, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = (p * vs[:, :, None, :]).to(bf16)
    acc = bmm_f32(pv, vq.to(bf16))  # (B, KV, R, hd)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention_q8(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    valid_len: ValidLen,
) -> torch.Tensor:
    """(B, KV, R, hd) attention output in q's dtype. CUDA: bf16 q, R <= 8,
    hd <= 256 and a multiple of 16."""
    if not q.is_cuda:
        return decode_attention_q8_reference(q, kq, ks, vq, vs, valid_len)
    B, KV, R, hd = q.shape
    T = kq.shape[2]
    check_cuda_tensor("q", q, torch.bfloat16)
    check_cuda_tensor("kq", kq, torch.int8, (B, KV, T, hd))
    check_cuda_tensor("vq", vq, torch.int8, (B, KV, T, hd))
    check_cuda_tensor("ks", ks, torch.float32, (B, KV, T))
    check_cuda_tensor("vs", vs, torch.float32, (B, KV, T))
    if R > 8 or hd > 256 or hd % 16:
        raise ValueError(f"decode_attention_q8: R={R} (<= 8), hd={hd} (a multiple of 16, <= 256)")
    valid = _valid_vec(valid_len, B, q.device)
    if tuple(valid.shape) != (B,):
        raise ValueError(f"decode_attention_q8: valid_len must be scalar or ({B},)")
    ns = KERNEL.lib().prego_decode_attention_q8_splits(T)
    out = torch.empty_like(q)
    part_acc = torch.empty(B, KV, ns, R, hd, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B, KV, ns, R, 2, dtype=torch.float32, device=q.device)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_decode_attention_q8",
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        valid.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        B, KV, R, T, hd, stream_ptr(q.device),
    )
    return out
