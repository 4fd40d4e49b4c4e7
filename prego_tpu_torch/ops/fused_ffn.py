"""K7a, K7 and K7q: the decode FFN in CUDA (``csrc/fused_ffn_bf16.cu``,
``csrc/fused_ffn_q8.cu``, ``csrc/fused_ffn.cu``).

K7a, port of prego_tpu/ops/fused_ffn.py::fused_ffn_block: returns
``h + ffn(rms_norm(h, norm_weight, eps))`` in h's dtype, with w13 the
fused [w1 | w3] (D, 2F) and w2 (F, D). The dtype walk is the JAX one:
f32 mean square and rsqrt, normed cast to h's dtype and then scaled by
the weight in h's dtype, f32-accumulated products, the SwiGLU activation
cast to h's dtype, and the residual add in h's dtype.

K7, port of ::fused_ffn: ``ffn(x)`` alone, silu(x.w1) * (x.w3) cast to
x's dtype, then .w2, returned as (M, D) f32 (the caller casts and adds).

K7q, port of ::fused_ffn_block_q8: K7a over weight-only int8 w13 (D, 2F)
and w2 (F, D) with f32 column scales w13s (1, 2F) and w2s (1, D), in the
JAX kernel's dequant convention (K4's): bf16 operands, f32 sums, w13's
scales on the up products, ``a`` cast to bf16, w2's scales on the final
sum, then the cast to h's dtype and the residual add.

On a CUDA tensor ``fused_ffn_block``, ``fused_ffn`` and
``fused_ffn_block_q8`` launch their kernel (bf16 activations); on a CPU
tensor they run ``fused_ffn_block_reference``, the unfused op sequence
``rms_norm -> feed_forward -> + h``, ``fused_ffn_reference`` and
``fused_ffn_block_q8_reference``. Which design a CUDA call takes follows
from (D, F) alone, and how many calls from M besides (``ffn_design``):

- K7a and K7: where the TMA ring takes the weights (D and F multiples of
  16, ``ring_splits``), one persistent launch of ``csrc/fused_ffn_bf16.cu``
  (a TMA ring and tensor-core products, its scratch in a persistent
  workspace) for up to 32 decode rows, so the weights are read once a
  decode step; more rows go in calls of 32. Where a split's activations
  for all of a call's rows would pass shared memory, the entry point
  itself makes launches of as many rows as fit. Other shapes take their
  first design, K7a's kernels in ``csrc/fused_ffn.cu``, 8 rows a launch.
- K7q: ``csrc/fused_ffn_q8.cu``'s ring where ``ring_splits`` takes (D, F),
  else K7a's first-design kernels over int8; 8 rows a launch either way.
"""

from __future__ import annotations

import functools

import torch

from prego_tpu_torch.ops._cuda import (
    CudaKernel, Workspace, c_float, c_int, c_ptr, check_cuda_tensor, stream_ptr,
)
from prego_tpu_torch.ops.dense import mm_f32

KERNEL = CudaKernel(
    "fused_ffn",
    "fused_ffn.cu",
    {"prego_fused_ffn_block": [c_ptr] * 8 + [c_int] * 4 + [c_float, c_ptr]},
)
KERNEL_FFN = CudaKernel(
    "fused_ffn_bf16",
    "fused_ffn_bf16.cu",
    {"prego_fused_ffn_tma": [c_ptr] * 8 + [c_int] * 5 + [c_ptr]},
)
# K7a's ring, in K7's library; its launches counted apart from the first
# design's (KERNEL)
KERNEL_BLOCK = CudaKernel(
    "fused_ffn_bf16",
    "fused_ffn_bf16.cu",
    {"prego_fused_ffn_block_tma": [c_ptr] * 9 + [c_int] * 5 + [c_float, c_ptr]},
)
KERNEL_Q8 = CudaKernel(
    "fused_ffn_q8",
    "fused_ffn_q8.cu",
    {"prego_fused_ffn_block_q8": [c_ptr] * 11 + [c_int] * 5 + [c_float, c_ptr]},
)
# K7's and K7q's first designs live in K7a's library, for the shapes whose
# weight rows TMA cannot take; their own entries keep their own launch counts
KERNEL_FFN_FFMA = CudaKernel(
    "fused_ffn", "fused_ffn.cu", {"prego_fused_ffn": [c_ptr] * 6 + [c_int] * 4 + [c_ptr]},
)
KERNEL_Q8_FFMA = CudaKernel(
    "fused_ffn",
    "fused_ffn.cu",
    {"prego_fused_ffn_block_q8": [c_ptr] * 10 + [c_int] * 4 + [c_float, c_ptr]},
)
# The rings' scratch, kept between calls (one set for K7 and K7a, one for
# K7q): the up units' partial sums (P, M, 2F) f32, a (M, F) bf16, the down
# units' partial sums (S, M, D) f32 and the counters (each column tile's
# arrivals and departures, the up units done, the blocks past their wait:
# zero, and left zero); the first designs' xn_t (K7q only), a_t and partial
# sums
WORKSPACE_FFN = Workspace((torch.float32, torch.bfloat16, torch.float32, torch.int32),
                          zero=(False, False, False, True))
WORKSPACE_Q8 = Workspace((torch.float32, torch.bfloat16, torch.float32, torch.int32),
                         zero=(False, False, False, True))
WORKSPACE_FFN_FFMA = Workspace((torch.bfloat16, torch.float32))
WORKSPACE_Q8_FFMA = Workspace((torch.bfloat16, torch.bfloat16, torch.float32))

MAX_DECODE_ROWS = 8  # rows one launch of a first design or of K7q's ring takes
RING_MAX_ROWS = 32  # rows one launch of K7's and K7a's ring takes: four n8 tiles of mma.sync


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """prego_tpu/models/llama/model.py:373-376: f32 statistics, the normed
    value cast to x's dtype, then scaled by the weight."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def feed_forward_reference(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """silu(x.w1) * (x.w3) cast to x's dtype, then .w2, as f32."""
    F = w2.shape[0]
    g13 = mm_f32(x, w13)
    act = (torch.nn.functional.silu(g13[..., :F]) * g13[..., F:]).to(x.dtype)
    return mm_f32(act, w2)


def fused_ffn_reference(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7."""
    return feed_forward_reference(x, w13, w2)


def fused_ffn_block_reference(
    h: torch.Tensor, norm_weight: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same dtype walk."""
    return h + feed_forward_reference(rms_norm(h, norm_weight, eps), w13, w2).to(h.dtype)


def fused_ffn_block_q8_reference(
    h: torch.Tensor, norm_weight: torch.Tensor, w13q: torch.Tensor, w13s: torch.Tensor,
    w2q: torch.Tensor, w2s: torch.Tensor, eps: float,
) -> torch.Tensor:
    """Plain PyTorch version of K7q, the JAX kernel's arithmetic: for bf16
    h, the unfused int8 sequence (rms_norm, K4, silu * up, K4, add)."""
    bf16 = torch.bfloat16
    F = w2q.shape[0]
    g13 = mm_f32(rms_norm(h, norm_weight, eps).to(bf16), w13q.to(bf16)) * w13s[0]
    a = (torch.nn.functional.silu(g13[..., :F]) * g13[..., F:]).to(bf16)
    return h + (mm_f32(a, w2q.to(bf16)) * w2s[0]).to(h.dtype)


def _check(name, x, w13, w2, wdtype=torch.bfloat16):
    """Raise unless the kernel takes these operands; returns (M, D, F, the
    number of blocks sharing the F reduction of W2)."""
    M, D = x.shape
    F = w2.shape[0]
    if M < 1 or D % 8 or F % 4:
        raise ValueError(f"{name}: M={M} (>= 1), D={D} (a multiple of 8), F={F} (of 4)")
    check_cuda_tensor("x", x, torch.bfloat16)
    check_cuda_tensor("w13", w13, wdtype, (D, 2 * F))
    check_cuda_tensor("w2", w2, wdtype, (F, D))
    return M, D, F, max(1, min(8, F // 128))


# the tiling of csrc/fused_ffn_q8.cu and csrc/fused_ffn_bf16.cu: stages of
# 32 weight rows, 256 gate (and 256 up) columns an up block, 512 output
# columns a down block
_RING_ROWS, _RING_UP_COLS, _RING_DOWN_COLS = 32, 256, 512
_RING_MAX_SPLIT_ROWS = 4096  # rows of activations a block stages


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def ring_splits(D: int, F: int, sms: int):
    """(P, S): the splits of D among the up units and of F among the down
    units of K7q's and K7's ring kernels, so that each phase has about one
    unit an SM; None where they do not take the shape (D or F no multiple
    of 16, where TMA cannot start a box, more column tiles than SMs, or a
    split's activations past shared memory)."""
    tiles13, tiles2 = _ceil(F, _RING_UP_COLS), _ceil(D, _RING_DOWN_COLS)
    if D % 16 or F % 16 or max(tiles13, tiles2) > sms:
        return None
    rows13, rows2 = _ceil(D, _RING_ROWS), _ceil(F, _RING_ROWS)
    P = min(sms // tiles13, rows13)
    S = min(sms // tiles2, rows2)
    if max(_ceil(rows13, P), _ceil(rows2, S)) * _RING_ROWS > _RING_MAX_SPLIT_ROWS:
        return None
    return P, S


def ffn_design(D: int, F: int, sms: int):
    """The dispatch rule of ``fused_ffn_block`` and ``fused_ffn``: ("ring",
    RING_MAX_ROWS) where the ring takes (D, F) (``ring_splits``), else
    ("first", MAX_DECODE_ROWS): the design, and the most rows a call of its
    entry point takes."""
    if ring_splits(D, F, sms) is None:
        return "first", MAX_DECODE_ROWS
    return "ring", RING_MAX_ROWS


def _ring_counters(D: int, F: int) -> int:
    """The ring kernels' counters: two a column tile of each phase, two more."""
    return 2 * (_ceil(F, _RING_UP_COLS) + _ceil(D, _RING_DOWN_COLS)) + 2


def _ring_scratch(F: int, sms: int):
    """K7's and K7a's workspace for RING_MAX_ROWS decode rows, the most a
    launch takes: part13 (P, rows, 2F), a (rows, F), part2 (S, rows, D), the
    counters. A split's column tile is 512 columns (256 gate and 256 up, or
    512 out) and there are at most ``sms`` units a phase, so P 2F and S D are
    at most 512 sms and the counters 4 sms + 2: the set made for one shape
    serves every shape of a card whose F is no larger, K7's and K7a's in one
    model alike, at every row count a step may have."""
    rows = RING_MAX_ROWS
    return 512 * sms * rows, rows * F, 512 * sms * rows, 4 * sms + 2


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_ffn(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x (M, D) already normed -> silu(x.w1) * (x.w3) . w2 as (M, D) f32."""
    if not x.is_cuda:
        return fused_ffn_reference(x, w13, w2)
    M, D, F, splits = _check("fused_ffn", x, w13, w2)
    sms = _num_sms(x.device.index)
    design, step = ffn_design(D, F, sms)
    if M > step:
        return torch.cat([fused_ffn(x[i : i + step], w13, w2) for i in range(0, M, step)])
    out = torch.empty(M, D, dtype=torch.float32, device=x.device)
    stream = stream_ptr(x.device)
    if design == "first":
        a_t, part = WORKSPACE_FFN_FFMA.get(x.device, stream, F * M, splits * M * D)
        KERNEL_FFN_FFMA.launches += 1
        KERNEL_FFN_FFMA.call(
            "prego_fused_ffn", x.data_ptr(), w13.data_ptr(), w2.data_ptr(), a_t.data_ptr(),
            part.data_ptr(), out.data_ptr(), M, D, F, splits, stream,
        )
        return out
    P, S = ring_splits(D, F, sms)
    part13, a, part2, counters = WORKSPACE_FFN.get(x.device, stream, *_ring_scratch(F, sms))
    KERNEL_FFN.launches += 1
    KERNEL_FFN.call(
        "prego_fused_ffn_tma", x.data_ptr(), w13.data_ptr(), w2.data_ptr(), part13.data_ptr(),
        a.data_ptr(), part2.data_ptr(), counters.data_ptr(), out.data_ptr(), M, D, F, P, S, stream,
    )
    return out


def fused_ffn_block(
    h: torch.Tensor,  # (M, D)
    norm_weight: torch.Tensor,  # (D,)
    w13: torch.Tensor,  # (D, 2F)
    w2: torch.Tensor,  # (F, D)
    eps: float,
) -> torch.Tensor:
    if not h.is_cuda:
        return fused_ffn_block_reference(h, norm_weight, w13, w2, eps)
    M, D, F, splits = _check("fused_ffn_block", h, w13, w2)
    check_cuda_tensor("norm_weight", norm_weight, torch.bfloat16, (D,))
    sms = _num_sms(h.device.index)
    design, step = ffn_design(D, F, sms)
    if M > step:
        return torch.cat([fused_ffn_block(h[i : i + step], norm_weight, w13, w2, eps)
                          for i in range(0, M, step)])
    out = torch.empty_like(h)
    stream = stream_ptr(h.device)
    if design == "first":
        xn_t = torch.empty(D, M, dtype=torch.bfloat16, device=h.device)
        a_t = torch.empty(F, M, dtype=torch.bfloat16, device=h.device)
        part = torch.empty(splits, M, D, dtype=torch.float32, device=h.device)
        KERNEL.launches += 1
        KERNEL.call(
            "prego_fused_ffn_block",
            h.data_ptr(), norm_weight.data_ptr(), w13.data_ptr(), w2.data_ptr(), xn_t.data_ptr(),
            a_t.data_ptr(), part.data_ptr(), out.data_ptr(), M, D, F, splits, float(eps), stream,
        )
        return out
    P, S = ring_splits(D, F, sms)
    part13, a, part2, counters = WORKSPACE_FFN.get(h.device, stream, *_ring_scratch(F, sms))
    KERNEL_BLOCK.launches += 1
    KERNEL_BLOCK.call(
        "prego_fused_ffn_block_tma",
        h.data_ptr(), norm_weight.data_ptr(), w13.data_ptr(), w2.data_ptr(), part13.data_ptr(),
        a.data_ptr(), part2.data_ptr(), counters.data_ptr(), out.data_ptr(), M, D, F, P, S,
        float(eps), stream,
    )
    return out


def fused_ffn_block_q8(
    h: torch.Tensor,  # (M, D)
    norm_weight: torch.Tensor,  # (D,)
    w13q: torch.Tensor,  # (D, 2F) int8
    w13s: torch.Tensor,  # (1, 2F) f32
    w2q: torch.Tensor,  # (F, D) int8
    w2s: torch.Tensor,  # (1, D) f32
    eps: float,
) -> torch.Tensor:
    """h + ffn(rms_norm(h)) over int8 weights, in h's dtype. CUDA: bf16 h
    and norm weight, D a multiple of 8, F of 4."""
    if not h.is_cuda:
        return fused_ffn_block_q8_reference(h, norm_weight, w13q, w13s, w2q, w2s, eps)
    M, D, F, splits = _check("fused_ffn_block_q8", h, w13q, w2q, torch.int8)
    check_cuda_tensor("norm_weight", norm_weight, torch.bfloat16, (D,))
    check_cuda_tensor("w13s", w13s, torch.float32, (1, 2 * F))
    check_cuda_tensor("w2s", w2s, torch.float32, (1, D))
    if M > MAX_DECODE_ROWS:
        return torch.cat([
            fused_ffn_block_q8(h[i : i + MAX_DECODE_ROWS], norm_weight, w13q, w13s, w2q, w2s, eps)
            for i in range(0, M, MAX_DECODE_ROWS)])
    out = torch.empty_like(h)
    stream = stream_ptr(h.device)
    design = ring_splits(D, F, _num_sms(h.device.index))
    if design is None:
        xn_t, a_t, part = WORKSPACE_Q8_FFMA.get(h.device, stream, D * M, F * M, splits * M * D)
        KERNEL_Q8_FFMA.launches += 1
        KERNEL_Q8_FFMA.call(
            "prego_fused_ffn_block_q8",
            h.data_ptr(), norm_weight.data_ptr(), w13q.data_ptr(), w13s.data_ptr(),
            w2q.data_ptr(), w2s.data_ptr(), xn_t.data_ptr(), a_t.data_ptr(), part.data_ptr(),
            out.data_ptr(), M, D, F, splits, float(eps), stream,
        )
        return out
    P, S = design
    part13, a, part2, counters = WORKSPACE_Q8.get(
        h.device, stream, P * M * 2 * F, M * F, S * M * D, _ring_counters(D, F))
    KERNEL_Q8.launches += 1
    KERNEL_Q8.call(
        "prego_fused_ffn_block_q8",
        h.data_ptr(), norm_weight.data_ptr(), w13q.data_ptr(), w13s.data_ptr(), w2q.data_ptr(),
        w2s.data_ptr(), part13.data_ptr(), a.data_ptr(), part2.data_ptr(), counters.data_ptr(),
        out.data_ptr(), M, D, F, P, S, float(eps), stream,
    )
    return out
