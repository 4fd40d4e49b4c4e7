"""A plain DeepSeek-V2 decoder (arXiv:2405.04434; HF ``DeepseekV2ForCausalLM``)
in float32 with TF32 off, over whole sequences: no cache, no kernels, no
batching. It imports nothing of ``prego_tpu_torch`` or JAX; the tests hand
it the tree the port serves and a plain dict of the configuration.

Per layer, pre-norm residuals with RMSNorm:
  multi-head latent attention, decompressed: q = h W_q per head
  [q_nope | q_pe]; [c_kv | k_pe] = h W_kva; c_kv normed (kv_a_layernorm);
  per head [k_nope | v] = c_kv W_kvb; q_pe and k_pe (one head for all)
  rotated by YaRN's tables; softmax([q_nope | q_pe] . [k_nope | k_pe] *
  softmax_scale) causal, times v, then W_o;
  then the dense SwiGLU (layers before first_k_dense_replace) or
  DeepSeekMoE: softmax over all routed experts per token, the greedy top k
  weighted by their scores with no renormalisation, plus the shared experts.

Departures, each invisible to random weights: the projections come in the
serving tree's layout (``wqkv_a`` = W_q's nope columns of every head | W_q's
rope columns of every head | W_kva's k_pe | c_kv columns; ``wkv_b`` per head
[k_nope | v]; each expert's w13 = w1 | w3); the rotary pairs are adjacent
(2i, 2i+1), which scores the same as HF's permute-then-rotate-halves.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def softmax_scale(c: Dict) -> float:
    rs = c["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5 * m * m


def yarn_tables(c: Dict, n: int, device):
    """cos, sin (n, dr / 2) of YaRN over the rotary dims: frequencies ramped
    from 1 / theta^(2i/dr) to 1 / (factor theta^(2i/dr)) between the
    correction dims of beta_fast and beta_slow; cos and sin times
    mscale / mscale_all_dim."""
    rs, dr, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]

    def dim_of(rot):
        return dr * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), dr - 1)
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low) / max(high - low, 0.001)).clamp(0, 1)
    pos = base ** (torch.arange(0, dr, 2, dtype=torch.float64) / dr)
    inv = (1.0 / (rs["factor"] * pos)) * ramp + (1.0 / pos) * (1.0 - ramp)
    inv = inv.float().to(device)
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    m = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    return ang.cos() * m, ang.sin() * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (S, heads, d), rotated in adjacent pairs by position."""
    S, n, d = x.shape
    a, b = x.reshape(S, n, d // 2, 2).unbind(-1)
    cc, ss = cos[:, None, :], sin[:, None, :]
    return torch.stack([a * cc - b * ss, a * ss + b * cc], dim=-1).reshape(S, n, d)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def swiglu(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    g = _mm(x, w13)
    F = g.shape[-1] // 2
    return _mm(torch.nn.functional.silu(g[:, :F]) * g[:, F:], w2)


def attention(x: torch.Tensor, p: Dict, c: Dict, cos, sin) -> torch.Tensor:
    """x + MLA(rms_norm(x)) over one sequence x (S, D), decompressed."""
    S = x.shape[0]
    H, dn, dr = c["n_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    dv, R = c["v_head_dim"], c["kv_lora_rank"]
    h = rms_norm(x, p["attention_norm"], c["norm_eps"])
    a = _mm(h, p["wqkv_a"])
    q_nope = a[:, :H * dn].reshape(S, H, dn)
    q_pe = rope(a[:, H * dn:H * (dn + dr)].reshape(S, H, dr), cos[:S], sin[:S])
    k_pe = rope(a[:, H * (dn + dr):H * (dn + dr) + dr].reshape(S, 1, dr), cos[:S], sin[:S])
    c_kv = rms_norm(a[:, H * (dn + dr) + dr:], p["kv_norm"], c["norm_eps"])
    kv = _mm(c_kv, p["wkv_b"]).reshape(S, H, dn + dv)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)  # (H, S, dn + dr)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], dim=-1).transpose(0, 1)
    v = kv[..., dn:].transpose(0, 1)
    scores = (q @ k.transpose(1, 2)) * softmax_scale(c)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    o = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(S, H * dv)
    return x + _mm(o, p["wo"])


def ffn(x: torch.Tensor, p: Dict, c: Dict) -> torch.Tensor:
    """x + the layer's FFN sub-layer over tokens x (N, D): the dense SwiGLU,
    or the routed experts of each token plus the shared experts."""
    h = rms_norm(x, p["ffn_norm"], c["norm_eps"])
    if "w13" in p:
        return x + swiglu(h, p["w13"], p["w2"])
    scores = torch.softmax(_mm(h, p["gate"]), dim=-1)
    w, idx = torch.topk(scores, c["num_experts_per_tok"], dim=-1)
    if c["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    w = w * c["routed_scaling_factor"]
    y = swiglu(h, p["shared_w13"], p["shared_w2"])
    for e in range(p["experts_w13"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y[tok] += w[tok, slot, None] * swiglu(h[tok], p["experts_w13"][e],
                                                  p["experts_w2"][e])
    return x + y


def f32_layer(lp: Dict) -> Dict[str, torch.Tensor]:
    """A layer of the serving tree as flat f32 leaves."""

    def w(t):
        return t.float()

    a = lp["attention"]
    out = {"attention_norm": lp["attention_norm"].float(), "ffn_norm": lp["ffn_norm"].float(),
           "kv_norm": a["kv_norm"].float(), "wqkv_a": w(a["wqkv_a"]), "wkv_b": w(a["wkv_b"]),
           "wo": w(a["wo"])}
    if "moe" in lp:
        m = lp["moe"]
        out.update(gate=w(m["gate"]), experts_w13=w(m["w13"]), experts_w2=w(m["w2"]),
                   shared_w13=w(m["shared"]["w13"]), shared_w2=w(m["shared"]["w2"]))
    else:
        out.update(w13=w(lp["feed_forward"]["w13"]), w2=w(lp["feed_forward"]["w2"]))
    return out


def logits(tree: Dict, c: Dict, seqs: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """The f32 logits (len(s), V) of each token sequence, every position."""
    with torch.no_grad():
        emb = tree["tok_embeddings"]
        dev = emb.device
        cos, sin = yarn_tables(c, max(len(s) for s in seqs), dev)
        xs = [emb[torch.as_tensor(list(s), device=dev)].float() for s in seqs]
        sizes = [len(s) for s in seqs]
        for lp in tree["layers"]:
            p = f32_layer(lp)
            xs = [attention(x, p, c, cos, sin) for x in xs]
            xs = list(ffn(torch.cat(xs), p, c).split(sizes))  # tokens are routed one by one
        w = tree["output"].float()
        return [rms_norm(x, tree["norm"].float(), c["norm_eps"]) @ w for x in xs]
