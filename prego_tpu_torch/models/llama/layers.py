"""The building blocks that the LLaMA block (``model.py``), multi-head
latent attention (``mla.py``) and DeepSeekMoE (``moe.py``) share: a
projection of a plain or int8 leaf, the rotary embedding and the SwiGLU
FFN. They read no configuration; ``model.py`` holds the decode fusion gates
that ``feed_forward`` takes."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from prego_tpu_torch.ops.dense import mm_f32
from prego_tpu_torch.ops.fused_ffn import fused_ffn
from prego_tpu_torch.ops.quant import int8_matmul, int8xint8_matmul, quantize_activations

Params = Dict[str, Any]


def is_quantized(leaf) -> bool:
    """An int8 projection leaf {"q", "s"[, "act"]}."""
    return isinstance(leaf, dict) and "q" in leaf


def dense(x: torch.Tensor, leaf, group=None) -> torch.Tensor:
    """x (..., K) times a projection leaf, f32 out: a plain tensor through
    ``mm_f32``, an int8 leaf through K4, an int8 leaf marked ``act``
    through ``quantize_activations`` and K5. ``group``: the tp group a
    row-parallel leaf's K is split over; the f32 partial products are
    summed there, and an ``act`` leaf's per-token amax is the group's max."""
    if not is_quantized(leaf):
        y = mm_f32(x, leaf)
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if "act" in leaf:
            amax = None
            if group is not None:
                amax = x2.float().abs().amax(dim=-1, keepdim=True)
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            xq, xs = quantize_activations(x2, amax)
            y = int8xint8_matmul(xq, xs, leaf["q"], leaf["s"])
        else:
            y = int8_matmul(x2, leaf["q"], leaf["s"])
        y = y.reshape(*lead, y.shape[-1])
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs. x: (B, S, H, hd); cos/sin: (S, hd/2), or
    (B, S, hd/2) per-row tables (per-row positions)."""
    B, S, H, hd = x.shape
    xf = x.float().reshape(B, S, H, hd // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c = cos[:, :, None, :] if cos.ndim == 3 else cos[None, :, None, :]
    s = sin[:, :, None, :] if sin.ndim == 3 else sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(B, S, H, hd).to(x.dtype)


def feed_forward(p: Params, x: torch.Tensor, gates, group=None) -> torch.Tensor:
    """silu(x.w1) * (x.w3) cast to x's dtype, then .w2, in x's dtype.
    Decode rows with bf16 weights in the fused layout run the K7 wrapper
    where ``gates.ffn`` (``model.FusionGates``) is on. ``group``: the tp
    group w2's rows are split over."""
    if "w13" in p:
        if not is_quantized(p["w13"]) and x.shape[1] == 1 and gates.ffn:
            B, S, D = x.shape
            return fused_ffn(x.reshape(B * S, D), p["w13"], p["w2"]).reshape(B, S, D).to(x.dtype)
        g13 = dense(x, p["w13"])
        F = g13.shape[-1] // 2
        gate, up = g13[..., :F], g13[..., F:]
    else:
        gate, up = dense(x, p["w1"]), dense(x, p["w3"])
    act = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    return dense(act, p["w2"], group).to(x.dtype)
