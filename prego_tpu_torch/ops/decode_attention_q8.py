"""K3 and K3m: bounded single-token decode attention over an int8 KV cache
(``csrc/decode_attention_q8.cu``).

Port of prego_tpu/ops/decode_attention.py::decode_attention_bounded_q8 in
its default mode (K3) and its ``int8_mxu=True`` mode (K3m, which no model
path selects, as in the JAX package). Its batch-folded and flat-head
Pallas bodies are TPU schedules of the same function and have no port of
their own, as with K2.

The cache leaves are int8 values (B, KV, T, hd) with one f32 scale per
(row, head, position), (B, KV, T). Semantics, kept by the plain version
too: q is rounded to bf16 and dotted with the int8 keys (exact products,
f32 sums), then multiplied by the key scale and 1/sqrt(hd); positions at
or past ``valid`` are masked and their p set to 0; l sums the f32 p;
``p * v_scale`` is rounded to bf16 before the product with the int8
values; out = acc / max(l, 1e-30) in q's dtype; valid == 0 gives zeros.

K3m replaces both products with exact int8 dots. q is quantized per
(row, head) over hd, ``qs = max(|q|, 1e-8) / 127``, rounded half to even;
``s = f32(int32 q8 . k) * qs * k_scale / sqrt(hd)``. ``pv = p * v_scale``
is quantized per query row of a 64-position split against the split's
largest value, ``ps = max(|pv|, 1e-30) / (127 * 128)``, and split into
7-bit codes hi and lo, ``acc = (f32(hi . v) * 128 + f32(lo . v)) * ps``;
the splits merge with the log-sum-exp rule. The JAX kernel quantizes pv
against its 256-position block under a running max instead, so the two
differ in their bits; each is held to the f32 reference on the
dequantized cache by the JAX package's bars.
"""

from __future__ import annotations

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
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
# K3m lives in the same library; its own entry keeps its own launch count
KERNEL_MXU = CudaKernel(
    "decode_attention_q8",
    "decode_attention_q8.cu",
    {
        "prego_decode_attention_q8_mxu": [c_ptr] * 9 + [c_int] * 5 + [c_ptr],
        "prego_decode_attention_q8_splits": [c_int],
    },
)
SPLIT = 64  # cache positions of a pass-1 block (csrc/decode_attention_q8.cu)
# the kernels' scratch, partial sums (B, KV, NS, R, hd) and their (m, l):
# pass 2 reads only what pass 1 wrote in the same call, so it is never
# cleared
SCRATCH = Workspace(torch.float32)


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


def _exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An integer-valued product summed exactly (float64 holds every int32
    sum), rounded once to f32 as the int32 -> f32 conversion rounds."""
    return torch.matmul(a.double(), b.double()).float()


def decode_attention_q8_mxu_reference(
    q: torch.Tensor,  # (B, KV, R, hd)
    kq: torch.Tensor,  # (B, KV, T, hd) int8
    ks: torch.Tensor,  # (B, KV, T) f32
    vq: torch.Tensor,
    vs: torch.Tensor,
    valid_len: ValidLen,
) -> torch.Tensor:
    """Plain PyTorch version of K3m, split by split as the kernel runs."""
    B, KV, R, hd = q.shape
    T = kq.shape[2]
    ns = -(-T // SPLIT)
    pad = ns * SPLIT - T
    valid = torch.clamp(_valid_vec(valid_len, B, q.device), max=T)
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q8 = torch.round(qf / qs)
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=q.device))  # the kernel's f32
    s = _exact_dot(q8, kq.transpose(-1, -2)) * qs * ks[:, :, None, :] * scale  # (B, KV, R, T)
    pos = torch.arange(ns * SPLIT, device=q.device)
    mask = (pos[None, :] < valid[:, None]).reshape(B, 1, 1, ns, SPLIT)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, KV, R, ns, SPLIT)
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)  # -inf in a split past the bound
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = p * torch.nn.functional.pad(vs, (0, pad)).reshape(B, KV, 1, ns, SPLIT)
    ps = torch.clamp(pv.abs().amax(dim=-1, keepdim=True), min=1e-30) / (127.0 * 128.0)
    pq = torch.round(pv / ps)
    hi = torch.floor(pq / 128.0)
    lo = pq - hi * 128.0
    v = torch.nn.functional.pad(vq, (0, 0, 0, pad)).reshape(B, KV, 1, ns, SPLIT, hd)
    acc = ((_exact_dot(hi[..., None, :], v)[..., 0, :] * 128.0
            + _exact_dot(lo[..., None, :], v)[..., 0, :]) * ps)  # (B, KV, R, ns, hd)
    # the log-sum-exp merge of the live splits, in the kernel's order
    live = (torch.arange(ns, device=q.device)[None, :] * SPLIT < valid[:, None])
    live = live.reshape(B, 1, 1, ns, 1)
    M = torch.where(live, m, -torch.inf).amax(dim=-2, keepdim=True)
    w = torch.where(live, torch.exp(m - M), 0.0)
    L = (l * w).sum(dim=-2)
    out = (acc * w).sum(dim=-2) * (1.0 / torch.clamp(L, min=1e-30))
    return out.to(q.dtype)


def decode_attention_q8(
    q: torch.Tensor,
    kq: torch.Tensor,
    ks: torch.Tensor,
    vq: torch.Tensor,
    vs: torch.Tensor,
    valid_len: ValidLen,
    int8_mxu: bool = False,
) -> torch.Tensor:
    """(B, KV, R, hd) attention output in q's dtype; ``int8_mxu``: K3m.
    CUDA: bf16 q, R <= 8, hd <= 256 and a multiple of 16; two launches, and
    out the only allocation once the scratch is as large as the call needs
    (calls on one stream share it in stream order)."""
    if not q.is_cuda:
        plain = decode_attention_q8_mxu_reference if int8_mxu else decode_attention_q8_reference
        return plain(q, kq, ks, vq, vs, valid_len)
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
    stream = stream_ptr(q.device)
    out = torch.empty_like(q)
    rows = B * KV * ns * R
    part_acc, part_ml = SCRATCH.get(q.device, stream, rows * hd, rows * 2)
    kernel = KERNEL_MXU if int8_mxu else KERNEL
    kernel.launches += 1
    kernel.call(
        "prego_decode_attention_q8_mxu" if int8_mxu else "prego_decode_attention_q8",
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        valid.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        B, KV, R, T, hd, stream,
    )
    return out

