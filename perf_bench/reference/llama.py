"""A plain LLaMA-family decoder (Mistral-7B's block: RMSNorm, rotary
embedding, grouped-query attention, SwiGLU, no biases, untied head) in
float32, over whole sequences: no cache, no kernels, no batching.

It follows the published description. Departures, each invisible to
random weights: the rotary embedding rotates adjacent pairs (2i, 2i+1) as
Meta's LLaMA code does, where the Hugging Face layout rotates halves, a
fixed permutation of wq's and wk's columns; the projections come fused in
the tree the harness drew (wqkv = wq | wk | wv, w13 = w1 | w3). Head h of
the queries reads key-value head h // (n_heads / n_kv_heads). Mistral's
sliding window (4096) is longer than any sequence here, so it masks
nothing and is left out.

``logits_at`` runs the layers one at a time over every sequence, each
layer's weights widened to float32 once, so that a 7B model fits beside
the bf16 tree on one card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

Quant = Optional[Callable[[torch.Tensor, str], torch.Tensor]]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (S, heads, hd), rotated in adjacent pairs by position."""
    S, n, hd = x.shape
    a, b = x.view(S, n, hd // 2, 2).unbind(-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([a * c - b * s, a * s + b * c], dim=-1).view(S, n, hd)


def rope_tables(hd: int, theta: float, n: int, device):
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=device) / hd)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return ang.cos().float(), ang.sin().float()


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Quant) -> torch.Tensor:
    if quant is not None:
        return quant(x, "act") @ w
    return x @ w


def layer(x: torch.Tensor, p: Dict[str, torch.Tensor], c: Dict, cos, sin,
          quant: Quant = None) -> torch.Tensor:
    """One block over one sequence x (S, D), f32 weights ``p``."""
    S, D = x.shape
    H, KV, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    h = rms_norm(x, p["attention_norm"], c["norm_eps"])
    qkv = _mm(h, p["wqkv"], quant)
    q = rope(qkv[:, :H * hd].reshape(S, H, hd), cos[:S], sin[:S])
    k = rope(qkv[:, H * hd:(H + KV) * hd].reshape(S, KV, hd), cos[:S], sin[:S])
    v = qkv[:, (H + KV) * hd:].reshape(S, KV, hd)
    rep = H // KV
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    scores = (q.transpose(0, 1) @ k.transpose(1, 2)) / hd ** 0.5  # (H, S, S)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    attn = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(S, H * hd)
    x = x + _mm(attn, p["wo"], quant)
    h = rms_norm(x, p["ffn_norm"], c["norm_eps"])
    g13 = _mm(h, p["w13"], quant)
    F = g13.shape[-1] // 2
    act = torch.nn.functional.silu(g13[:, :F]) * g13[:, F:]
    return x + _mm(act, p["w2"], quant)


def _f32_layer(lp: Dict, quant: Quant) -> Dict[str, torch.Tensor]:
    out = {"attention_norm": lp["attention_norm"].float(), "ffn_norm": lp["ffn_norm"].float()}
    for group in ("attention", "feed_forward"):
        for k, w in lp[group].items():
            w = w.float()
            out[k] = quant(w, "weight") if quant is not None else w
    return out


@torch.no_grad()
def logits_at(tree: Dict, c: Dict, seqs: Sequence[Sequence[int]],
              positions: Sequence[Sequence[int]], quant: Quant = None) -> List[torch.Tensor]:
    """For each token sequence, the f32 logits (len(pos), V) at its listed
    positions (the logits at position p score the token at p + 1).
    ``quant`` rounds every product's operands (the lower-precision
    control); None is the float32 reference."""
    emb = tree["tok_embeddings"]
    dev = emb.device
    longest = max(len(s) for s in seqs)
    cos, sin = rope_tables(c["head_dim"], c["rope_theta"], longest, dev)
    xs = [emb[torch.as_tensor(list(s), device=dev)].float() for s in seqs]
    for lp in tree["layers"]:
        p = _f32_layer(lp, quant)
        xs = [layer(x, p, c, cos, sin, quant) for x in xs]
        del p
    norm = tree["norm"].float()
    out_w = tree["output"].float()
    if quant is not None:
        out_w = quant(out_w, "weight")
    out = []
    for x, pos in zip(xs, positions):
        h = rms_norm(x[torch.as_tensor(list(pos), device=dev)], norm, c["norm_eps"])
        out.append(_mm(h, out_w, quant))
    return out


def served_gaps(tree: Dict, c: Dict, prompts: Sequence[Sequence[int]],
                served: Sequence[Sequence[int]], quant: Quant = None,
                eos: Optional[int] = None, max_gen: Optional[int] = None
                ) -> List[List[float]]:
    """For each request, the gap by which each served token's reference
    logit lies below the reference's best at its position (0 for the
    reference's own greedy token). A request cut short of ``max_gen``
    tokens also scores ``eos`` at the next position."""
    seqs, positions, targets = [], [], []
    for p, s in zip(prompts, served):
        toks = list(s)
        if eos is not None and max_gen is not None and len(toks) < max_gen:
            toks = toks + [eos]
        seqs.append(list(p) + list(s))
        positions.append([len(p) - 1 + j for j in range(len(toks))])
        targets.append(toks)
    # the appended eos is scored, never fed: the sequence stops at the served tokens
    logits = logits_at(tree, c, seqs, positions, quant)
    gaps = []
    for lg, t in zip(logits, targets):
        idx = torch.as_tensor(t, device=lg.device)
        best = lg.max(dim=-1).values
        gaps.append((best - lg.gather(1, idx[:, None])[:, 0]).tolist())
    return gaps


def control_gaps(tree: Dict, c: Dict, prompts: Sequence[Sequence[int]],
                 served: Sequence[Sequence[int]], quant: Quant) -> List[List[float]]:
    """The control: at each position of the same prompts and served tokens,
    the token that the lower precision puts first, scored by the float32
    reference's gap."""
    seqs = [list(p) + list(s) for p, s in zip(prompts, served)]
    positions = [[len(p) - 1 + j for j in range(len(s))] for p, s in zip(prompts, served)]
    ref = logits_at(tree, c, seqs, positions)
    low = logits_at(tree, c, seqs, positions, quant)
    out = []
    for r, l in zip(ref, low):
        pick = l.argmax(dim=-1)
        out.append((r.max(dim=-1).values - r.gather(1, pick[:, None])[:, 0]).tolist())
    return out
