"""Peaks, the operations and bytes of each kernel and model, and the
arithmetic that turns device spans into busy time.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W, dense
rates: a share of them is stated beside the card's ``power.limit``. A
kernel's bound is the larger of its operations over the peak rate and
its bytes over the memory bandwidth (the ``chip_smoke.py`` arithmetic),
counting each input byte once and each output byte once, for the work
these inputs need.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12  # dense bf16 / fp16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12  # bytes/s
BF16 = 2  # bytes


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


# ---- the device's time (a frozen copy of core/profiling.py's arithmetic) ----

def span_union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """(start, end) intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of the intervals: overlapping work counts once."""
    return sum(e - s for s, e in span_union(spans))


def idle_gaps(spans: Iterable[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [start, end] that no span covers."""
    gaps, t = [], start
    for s, e in span_union(spans):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


# ---- the LLaMA-family decoder ----

def llama_matmul_params(c: Dict) -> int:
    """Weights one token's pass through the layers multiplies (no lm-head)."""
    D, H, KV, hd, F = c["dim"], c["n_heads"], c["n_kv_heads"], c["head_dim"], c["ffn_hidden"]
    return c["n_layers"] * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F)


def llama_flops(c: Dict, positions: Sequence[int], head_rows: int) -> float:
    """FLOPs of running tokens at the given absolute positions through the
    layers (each attends to its position + 1 keys), plus ``head_rows`` rows
    of the lm-head."""
    per_token = 2 * llama_matmul_params(c)
    attn = 4 * c["n_layers"] * c["n_heads"] * c["head_dim"]  # QK^T and PV, a key
    keys = sum(p + 1 for p in positions)
    return per_token * len(positions) + attn * keys + 2 * head_rows * c["dim"] * c["vocab_size"]


def llama_call_flops(c: Dict, prompts: Sequence[Sequence[int]], served: Sequence[int]) -> float:
    """The model FLOPs one completion call's inputs need: the common prefix
    of its prompts once, each prompt's suffix after it, and each served
    token but the last through the layers; one lm-head row a served token."""
    common = min(len(p) for p in prompts)
    first = prompts[0]
    shared = 0
    while shared < common and all(p[shared] == first[shared] for p in prompts):
        shared += 1
    shared = min(shared, common - 1)  # the last prompt token gives the first logits
    positions = list(range(shared))
    heads = 0
    for p, n in zip(prompts, served):
        positions.extend(range(shared, len(p) + max(n - 1, 0)))
        heads += n
    return llama_flops(c, positions, heads)


def k7a_launch(c: Dict, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K7a, the decode FFN sub-layer of one layer over
    ``rows`` tokens: the norm, w13 and w2 read once, the rows in and out."""
    D, F = c["dim"], c["ffn_hidden"]
    flops = 2 * rows * 3 * D * F
    nbytes = BF16 * (3 * D * F + D + 2 * rows * D)
    return flops, nbytes


def k2_launch(c: Dict, rows: int, keys: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K2, decode attention of one layer over ``rows``
    rows that each attend to ``keys`` cached positions: the live K and V
    read once, the queries in and the outputs out."""
    H, KV, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    flops = 4 * rows * H * keys * hd
    nbytes = BF16 * (2 * rows * KV * keys * hd + 2 * rows * H * hd)
    return flops, nbytes


# ---- the MiniROAD recognizer ----

def gru_fwd_launch(rows: int, frames: int, hidden: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K1: the recurrence h W_hh over ``frames`` frames of
    ``rows`` rows; bf16 input gates in, W_hh in, the states out."""
    H = hidden
    flops = 2 * rows * frames * H * 3 * H
    nbytes = BF16 * (rows * frames * 3 * H + H * 3 * H + rows * frames * H)
    return flops, nbytes


def gru_bwd_launch(rows: int, frames: int, hidden: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of K6: the gate recompute (h W_hh) and the dh chain
    (dHG W_hh^T) a frame; the input gates, the states, their gradients and
    W_hh in, the gates' gradients out."""
    H = hidden
    flops = 4 * rows * frames * H * 3 * H
    nbytes = BF16 * (2 * rows * frames * 3 * H + 2 * rows * frames * H + H * 3 * H)
    return flops, nbytes


def miniroad_step_flops(rows: int, frames: int, rgb_dim: int, embed: int, hidden: int,
                        classes: int) -> float:
    """FLOPs of one train step of MiniROAD on ``rows`` windows of
    ``frames`` frames (flow structurally zero): the embedding, the input
    gates and the recurrence over every frame, the classifier on the last;
    the backward's products twice the forward's, less the embedding's
    input gradient, which no parameter needs."""
    BT = rows * frames
    embed_f = 2 * BT * rgb_dim * embed
    gates_f = 2 * BT * embed * 3 * hidden
    rec_f = 2 * BT * hidden * 3 * hidden
    cls_f = 2 * rows * hidden * classes
    return 2 * embed_f + 3 * (gates_f + rec_f + cls_f)


def miniroad_frame_flops(rgb_dim: int, embed: int, hidden: int, classes: int) -> float:
    """FLOPs of one strictly causal frame of one stream (``forward_step``)."""
    return 2 * (rgb_dim * embed + embed * 3 * hidden + hidden * 3 * hidden + hidden * classes)


def share(num: float, den: float) -> float:
    """num / den in percent; NaN where den is 0."""
    return 100.0 * num / den if den > 0 else math.nan
