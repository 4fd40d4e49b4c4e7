"""LLaMA decoder in PyTorch (port of prego_tpu/models/llama/model.py,
bf16 paths).

Parity surface: the Meta reference decoder (step_anticipation/llama/
model.py:19-487): RMSNorm, rotary embeddings (here the equivalent real
rotation of adjacent pairs), grouped-query attention, SwiGLU FFN, final
norm and output head.

Layout and numerics follow the JAX package, so parameters cross over
through ``checkpoint/bridge.py`` unchanged: dense weights are stored
(in, out) for right-multiplication; the serving layout fuses wq|wk|wv
into wqkv and w1|w3 into w13 (``fuse_projections``); the KV cache is one
head-major (B, KV, T, hd) tensor per layer; products accumulate in f32
(``mm_f32``), softmax, norms and logits are f32.

Unlike the JAX package's functional cache, the port writes each step's
K/V into the cache tensors in place (``forward`` returns the same
tensors), which keeps one copy of the cache in device memory. Callers
that must keep a cache unchanged (the prefix LRU) pass a clone.

Decode (one token per row) runs the two ported kernels: K2 bounded decode
attention and K7a, the fused FFN sub-layer. Prefill (S > 1), the
projections, the lm-head and sampling are plain PyTorch, as they are
plain XLA in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from prego_tpu_torch.models.llama.config import LlamaConfig
from prego_tpu_torch.ops.decode_attention import decode_attention
from prego_tpu_torch.ops.dense import bmm_f32, mm_f32
from prego_tpu_torch.ops.fused_ffn import feed_forward_reference, fused_ffn_block, rms_norm

Params = Dict[str, Any]
Cache = Dict[str, List[torch.Tensor]]  # {"k": [per-layer], "v": [per-layer]}

__all__ = [
    "init_params", "fuse_projections", "init_cache", "rms_norm",
    "precompute_rope", "apply_rope", "forward",
]


# ---- initialization ----

def init_params(
    config: LlamaConfig, generator: torch.Generator, dtype=torch.bfloat16, device="cpu"
) -> Params:
    """Random init, normal scaled by 1/sqrt(d_in) (the JAX package's
    distribution; its draws differ). Real weights come from a converter."""
    D, V, F = config.dim, config.vocab_size, config.ffn_hidden
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim

    def dense(d_in, d_out):
        w = torch.randn(d_in, d_out, generator=generator, device=device, dtype=torch.float32)
        return (w * d_in ** -0.5).to(dtype)

    def ones():
        return torch.ones(D, dtype=dtype, device=device)

    layers = []
    for _ in range(config.n_layers):
        layers.append(
            {
                "attention": {
                    "wq": dense(D, H * hd),
                    "wk": dense(D, KV * hd),
                    "wv": dense(D, KV * hd),
                    "wo": dense(H * hd, D),
                },
                "feed_forward": {"w1": dense(D, F), "w2": dense(F, D), "w3": dense(D, F)},
                "attention_norm": ones(),
                "ffn_norm": ones(),
            }
        )
    return {
        "tok_embeddings": dense(V, D),
        "layers": layers,
        "norm": ones(),
        "output": dense(D, V),
    }


def fuse_projections(params: Params) -> Params:
    """Serving layout: wq|wk|wv -> wqkv and w1|w3 -> w13, one projection
    product each on the decode path."""
    out = {
        "tok_embeddings": params["tok_embeddings"],
        "norm": params["norm"],
        "output": params["output"],
        "layers": [],
    }
    for layer in params["layers"]:
        a, f = layer["attention"], layer["feed_forward"]
        out["layers"].append(
            {
                "attention": {
                    "wqkv": torch.cat([a["wq"], a["wk"], a["wv"]], dim=1),
                    "wo": a["wo"],
                },
                "feed_forward": {"w13": torch.cat([f["w1"], f["w3"]], dim=1), "w2": f["w2"]},
                "attention_norm": layer["attention_norm"],
                "ffn_norm": layer["ffn_norm"],
            }
        )
    return out


def init_cache(config: LlamaConfig, batch: int, dtype=torch.bfloat16, device="cpu") -> Cache:
    """Per-layer head-major (B, KV, T, hd) K and V tensors."""
    shape = (batch, config.kv_heads, config.max_seq_len, config.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(config.n_layers)],
        "v": [torch.zeros(shape, dtype=dtype, device=device) for _ in range(config.n_layers)],
    }


def clone_cache(cache: Cache, batch: Optional[int] = None) -> Cache:
    """A copy of ``cache``; with ``batch``, its B=1 rows repeated to that batch."""
    if batch is None:
        return {key: [t.clone() for t in cache[key]] for key in ("k", "v")}
    return {key: [t.repeat(batch, 1, 1, 1) for t in cache[key]] for key in ("k", "v")}


# ---- building blocks ----

def precompute_rope(config: LlamaConfig, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (2 * max_seq_len, head_dim // 2), f32."""
    hd = config.head_dim
    inv_freq = 1.0 / (
        config.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    )
    t = torch.arange(2 * config.max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs. x: (B, S, H, hd); cos/sin: (S, hd/2)."""
    B, S, H, hd = x.shape
    xf = x.float().reshape(B, S, H, hd // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(B, S, H, hd).to(x.dtype)


def _attention(
    p: Params,
    h: torch.Tensor,  # (B, S, D) pre-norm residual stream
    norm_weight: torch.Tensor,
    start_pos: int,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k: torch.Tensor,  # (B, KV, T, hd), written in place
    cache_v: torch.Tensor,
    config: LlamaConfig,
    valid: Optional[torch.Tensor],  # (B,) int32 decode bound, start_pos + 1
) -> torch.Tensor:
    """Returns h + attention(rms_norm(h)), writing this step's K/V into
    the cache at [start_pos, start_pos + S)."""
    B, S, D = h.shape
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim
    x = rms_norm(h, norm_weight, config.norm_eps)
    if "wqkv" in p:
        xqkv = mm_f32(x, p["wqkv"]).to(x.dtype)
    else:
        xqkv = torch.cat([mm_f32(x, p[w]).to(x.dtype) for w in ("wq", "wk", "wv")], dim=-1)
    # q and k heads rotate together: one rope pass over H + KV heads
    qk = apply_rope(xqkv[..., : (H + KV) * hd].reshape(B, S, H + KV, hd), cos, sin)
    xq, xk = qk[:, :, :H], qk[:, :, H:]
    xv = xqkv[..., (H + KV) * hd :].reshape(B, S, KV, hd)

    cache_k[:, :, start_pos : start_pos + S] = xk.transpose(1, 2).to(cache_k.dtype)
    cache_v[:, :, start_pos : start_pos + S] = xv.transpose(1, 2).to(cache_v.dtype)

    q = xq.reshape(B, S, KV, H // KV, hd)
    if S == 1:
        # one token per row: the bounded decode kernel (K2)
        out = decode_attention(q[:, 0].contiguous(), cache_k, cache_v, valid)
        out = out.reshape(B, 1, H * hd).to(x.dtype)
    else:
        # GQA against the full cache with a causal mask (model.py:613-636)
        T = cache_k.shape[2]
        qh = q.permute(0, 2, 3, 1, 4)  # (B, KV, R, S, hd)
        scores = bmm_f32(qh, cache_k[:, :, None].transpose(-1, -2)) / (hd ** 0.5)
        q_pos = start_pos + torch.arange(S, device=h.device)[:, None]
        k_pos = torch.arange(T, device=h.device)[None, :]
        scores = torch.where(k_pos <= q_pos, scores, float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = bmm_f32(probs, cache_v[:, :, None]).to(x.dtype)  # (B, KV, R, S, hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd)
    return h + mm_f32(out, p["wo"]).to(x.dtype)


def _ffn_sublayer(layer: Params, h: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """h + ffn(rms_norm(h, ffn_norm)). Decode rows in the fused layout run
    the K7a wrapper; prefill runs the same op sequence unfused."""
    p = layer["feed_forward"]
    nw = layer["ffn_norm"]
    B, S, D = h.shape
    if "w13" in p and S == 1:
        return fused_ffn_block(h.reshape(B, D), nw, p["w13"], p["w2"], config.norm_eps).reshape(
            B, 1, D
        )
    x = rms_norm(h, nw, config.norm_eps)
    if "w13" in p:
        return h + feed_forward_reference(x, p["w13"], p["w2"]).to(h.dtype)
    act = (torch.nn.functional.silu(mm_f32(x, p["w1"])) * mm_f32(x, p["w3"])).to(x.dtype)
    return h + mm_f32(act, p["w2"]).to(h.dtype)


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, S) int64
    start_pos: int,
    cache: Cache,
    config: LlamaConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Decoder forward at a scalar ``start_pos``. Returns (f32 logits
    (B, S, V), the cache, updated in place)."""
    if rope is None:
        rope = precompute_rope(config, device=tokens.device)
    cos_full, sin_full = rope
    B, S = tokens.shape
    cos = cos_full[start_pos : start_pos + S]
    sin = sin_full[start_pos : start_pos + S]
    emb = params["tok_embeddings"]
    V = emb.shape[0]
    # negative ids (the -1 pad) wrap like jnp.take's index normalisation
    h = emb[torch.where(tokens < 0, tokens + V, tokens)]
    valid = (
        torch.full((B,), start_pos + 1, dtype=torch.int32, device=tokens.device)
        if S == 1 else None
    )
    for i, layer in enumerate(params["layers"]):
        h = _attention(
            layer["attention"], h, layer["attention_norm"], start_pos, cos, sin,
            cache["k"][i], cache["v"][i], config, valid,
        )
        h = _ffn_sublayer(layer, h, config)
    h = rms_norm(h, params["norm"], config.norm_eps)
    return mm_f32(h, params["output"]), cache
