"""K8 and K8u: decode attention with the output projection fused, in CUDA
(``csrc/decode_attention_wo.cu``).

Port of prego_tpu/ops/decode_attention.py::decode_attention_bounded_wo
(K8, with and without the residual epilogue) and
::decode_attention_bounded_wo_res_upd (K8u). Semantics, kept by the plain
versions too: K2's attention output ``o`` (decode_attention.py here) is
cast to wo's dtype and projected, ``proj = o . wo`` summed in f32:

  decode_attention_wo(q, cache_k, cache_v, valid, wo)            -> proj, (B, 1, D) f32
  decode_attention_wo(..., residual=h)                           -> h + proj in h's dtype
  decode_attention_wo_res_upd(q, h, k_new, v_new, k, v, pos, wo) -> (h + proj, k, v)

K8u first writes this token's key and value (B, KV, 1, hd) into the caches
at ``pos`` in place and then attends over positions <= pos (valid = pos +
1); the caches it returns are the tensors it was given. ``pos`` and
``valid`` are ints, 0-d or (B,) tensors, and stay on the device.

On a CUDA tensor the wrappers launch the kernel (bf16, R <= 8, hd a
multiple of 16 up to 256, D a multiple of 8; more than 8 rows go in calls
of 8) or raise; on a CPU tensor they run the plain versions, which compose
``decode_attention_reference``, ``mm_f32`` and the add. A call of up to 8
rows allocates its output alone: the kernel's partial sums and counters
live in a workspace kept per (device, stream), whose counters the kernel
leaves zero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
from prego_tpu_torch.ops.decode_attention import ValidLen, _valid_vec, decode_attention_reference
from prego_tpu_torch.ops.dense import mm_f32

_SPLITS = {"prego_decode_attention_wo_splits": [c_int]}
KERNEL = CudaKernel(
    "decode_attention_wo",
    "decode_attention_wo.cu",
    {"prego_decode_attention_wo": [c_ptr] * 11 + [c_int] * 6 + [c_ptr], **_SPLITS},
)
# K8u lives in the same library; its own entry keeps its own launch count
KERNEL_UPD = CudaKernel(
    "decode_attention_wo",
    "decode_attention_wo.cu",
    {"prego_decode_attention_wo_res_upd":
         [c_ptr] * 4 + [c_int] * 2 + [c_ptr] * 9 + [c_int] * 6 + [c_ptr], **_SPLITS},
)

MAX_ROWS = 8  # batch rows one kernel call takes
PROJ_COLS = 64  # output columns of a projection block, one counter each (csrc/decode_attention_wo.cu)
# pass 1's partial sums (B, KV, NS, R, hd) and (m, l), the head partials
# (H, B, D) and the column tiles' counters (zero between calls); K8 and K8u
# share it
WORKSPACE = Workspace((torch.float32,) * 3 + (torch.int32,), zero=(False,) * 3 + (True,))


def decode_attention_wo_reference(
    q: torch.Tensor,  # (B, KV, R, hd)
    cache_k: torch.Tensor,  # (B, KV, T, hd)
    cache_v: torch.Tensor,
    valid_len: ValidLen,
    wo: torch.Tensor,  # (KV * R * hd, D)
    residual: Optional[torch.Tensor] = None,  # (B, 1, D)
) -> torch.Tensor:
    """Plain PyTorch version of K8, same semantics."""
    B = q.shape[0]
    o = decode_attention_reference(q, cache_k, cache_v, valid_len).reshape(B, 1, -1)
    proj = mm_f32(o.to(wo.dtype), wo)  # (B, 1, D) f32
    return proj if residual is None else residual + proj.to(residual.dtype)


def write_token_kv(
    k_new: torch.Tensor, v_new: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
    pos: ValidLen,
) -> torch.Tensor:
    """Write (B, KV, 1, hd) k_new / v_new into the caches at each row's pos,
    in place; returns pos as a (B,) int64 tensor."""
    B = k_new.shape[0]
    p = _valid_vec(pos, B, k_new.device).long()
    rows = torch.arange(B, device=k_new.device)
    cache_k[rows, :, p] = k_new[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, p] = v_new[:, :, 0].to(cache_v.dtype)
    return p


def decode_attention_wo_res_upd_reference(
    q: torch.Tensor, residual: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
    cache_k: torch.Tensor, cache_v: torch.Tensor, pos: ValidLen, wo: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K8u: write, then K8 with the residual."""
    p = write_token_kv(k_new, v_new, cache_k, cache_v, pos)
    h = decode_attention_wo_reference(q, cache_k, cache_v, p + 1, wo, residual)
    return h, cache_k, cache_v


def _check(q, cache_k, cache_v, wo, residual, name):
    B, KV, R, hd = q.shape
    T = cache_k.shape[2]
    D = wo.shape[1]
    check_cuda_tensor("q", q, torch.bfloat16)
    check_cuda_tensor("cache_k", cache_k, torch.bfloat16, (B, KV, T, hd))
    check_cuda_tensor("cache_v", cache_v, torch.bfloat16, (B, KV, T, hd))
    check_cuda_tensor("wo", wo, torch.bfloat16, (KV * R * hd, D))
    if residual is not None:
        check_cuda_tensor("residual", residual, torch.bfloat16, (B, 1, D))
    if R > 8 or hd > 256 or hd % 16 or D % 8:
        raise ValueError(f"{name}: R={R} (<= 8), hd={hd} (a multiple of 16, <= 256), "
                         f"D={D} (a multiple of 8)")
    return B, KV, R, T, hd, D


def _workspace(B, KV, R, T, hd, D, device, stream):
    rows = B * KV * KERNEL.lib().prego_decode_attention_wo_splits(T) * R
    return WORKSPACE.get(device, stream, rows * hd, rows * 2, KV * R * B * D, -(-D // PROJ_COLS))


def decode_attention_wo(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    valid_len: ValidLen,
    wo: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, 1, D): attention . wo in f32, or residual + it in residual's dtype."""
    if not q.is_cuda:
        return decode_attention_wo_reference(q, cache_k, cache_v, valid_len, wo, residual)
    B, KV, R, T, hd, D = _check(q, cache_k, cache_v, wo, residual, "decode_attention_wo")
    valid = _valid_vec(valid_len, B, q.device)
    if tuple(valid.shape) != (B,):
        raise ValueError(f"decode_attention_wo: valid_len must be scalar or ({B},)")
    if B > MAX_ROWS:
        return torch.cat([
            decode_attention_wo(q[i : i + MAX_ROWS], cache_k[i : i + MAX_ROWS],
                                cache_v[i : i + MAX_ROWS], valid[i : i + MAX_ROWS], wo,
                                None if residual is None else residual[i : i + MAX_ROWS])
            for i in range(0, B, MAX_ROWS)])
    stream = stream_ptr(q.device)
    ws = _workspace(B, KV, R, T, hd, D, q.device, stream)
    out = torch.empty(B, 1, D, dtype=torch.float32 if residual is None else residual.dtype,
                      device=q.device)
    KERNEL.launches += 1
    KERNEL.call(
        "prego_decode_attention_wo",
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), valid.data_ptr(), wo.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        *(w.data_ptr() for w in ws), B, KV, R, T, hd, D, stream,
    )
    return out


def _row_stride(name: str, t: torch.Tensor, shape) -> int:
    """The batch stride of a (B, KV, 1, hd) bf16 CUDA view whose (KV, hd)
    rows are dense and 16-byte aligned (a slice of the qkv activations)."""
    B, KV, _, hd = shape
    if not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected a CUDA bf16 tensor of shape {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(3) != 1 or (KV > 1 and t.stride(1) != hd) or t.data_ptr() % 16:
        raise ValueError(f"{name}: each row's (KV, hd) values must be dense and 16-byte aligned")
    stride = t.stride(0) if B > 1 else KV * hd
    if stride % 8 or stride < KV * hd:
        raise ValueError(f"{name}: batch stride {stride} (a multiple of 8, >= KV * hd)")
    return stride


def decode_attention_wo_res_upd(
    q: torch.Tensor,
    residual: torch.Tensor,
    k_new: torch.Tensor,  # (B, KV, 1, hd)
    v_new: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: ValidLen,
    wo: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(residual + attention . wo, cache_k, cache_v), the caches written at
    pos in place first."""
    if not q.is_cuda:
        return decode_attention_wo_res_upd_reference(
            q, residual, k_new, v_new, cache_k, cache_v, pos, wo)
    B, KV, R, T, hd, D = _check(q, cache_k, cache_v, wo, residual, "decode_attention_wo_res_upd")
    k_stride = _row_stride("k_new", k_new, (B, KV, 1, hd))
    v_stride = _row_stride("v_new", v_new, (B, KV, 1, hd))
    p = _valid_vec(pos, B, q.device)
    if tuple(p.shape) != (B,):
        raise ValueError(f"decode_attention_wo_res_upd: pos must be scalar or ({B},)")
    if B > MAX_ROWS:
        out = torch.cat([
            decode_attention_wo_res_upd(
                q[i : i + MAX_ROWS], residual[i : i + MAX_ROWS], k_new[i : i + MAX_ROWS],
                v_new[i : i + MAX_ROWS], cache_k[i : i + MAX_ROWS], cache_v[i : i + MAX_ROWS],
                p[i : i + MAX_ROWS], wo)[0]
            for i in range(0, B, MAX_ROWS)])
        return out, cache_k, cache_v
    stream = stream_ptr(q.device)
    ws = _workspace(B, KV, R, T, hd, D, q.device, stream)
    out = torch.empty_like(residual)
    KERNEL_UPD.launches += 1
    KERNEL_UPD.call(
        "prego_decode_attention_wo_res_upd",
        q.data_ptr(), residual.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_stride,
        v_stride, cache_k.data_ptr(), cache_v.data_ptr(), p.data_ptr(), wo.data_ptr(),
        out.data_ptr(), *(w.data_ptr() for w in ws), B, KV, R, T, hd, D, stream,
    )
    return out, cache_k, cache_v
