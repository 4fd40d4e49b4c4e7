"""Multi-head latent attention (MLA), DeepSeek-V2's attention (arXiv:2405.04434
§2.1; HF ``DeepseekV2Attention`` without a query LoRA), with a latent cache.

Per layer, h = rms_norm(x):
  q = h W_q, per head [q_nope | q_pe];  [c_kv | k_pe] = h W_kva;
  c_kv <- rms_norm(c_kv) (``kv_a_layernorm``);  per head [k_nope | v] = c_kv W_kvb;
  q_pe and k_pe (one head, shared by all) rotated by YaRN's tables;
  score = [q_nope | q_pe] . [k_nope | k_pe] * softmax_scale, causal;
  out = (softmax . v) W_o.

The cache holds what a position needs and nothing decompressed: the
normalised c_kv as ``cache["k"]`` (B, 1, T, kv_lora_rank) and the rotated
k_pe as ``cache["v"]`` (B, 1, T, qk_rope_head_dim), one "head" each, so
that ``clone_cache``, ``_cache_index``, the prefix LRU and the per-row
``index_copy_`` work on it as on a LLaMA cache. Every step, prefill and
decode alike, runs the absorbed form over the live latents: per head
q_lat = q_nope W_UK^T, score = q_lat . c_kv + q_pe . k_pe, o_lat = p . c_kv,
o = o_lat W_UV, with W_UK and W_UV the two halves of W_kvb's columns read
in place. No K or V of the cache is ever decompressed. A scalar position
reads the first start_pos + S latents, a per-row one the whole cache under
a mask of each row's own bound.

Layout of the serving tree (departures from the published weights, which
no random weight can see): ``wqkv_a`` (D, H dn + H dr + dr + R) holds W_q's
nope columns of every head, then W_q's rope columns of every head, then
W_kva's k_pe and c_kv columns, so that q_pe and k_pe rotate in one pass;
``wkv_b`` (R, H (dn + dv)) is W_kvb with each head's [k_nope | v].
The rotary pairs are adjacent (2i, 2i+1), which HF's DeepSeek-V2 reaches
by permuting q_pe and k_pe alike before rotating halves; scores do not
change. Serving is bf16 with f32 products' sums, f32 softmax and norms,
as on the LLaMA path.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from prego_tpu_torch.models.llama.config import DeepseekV2Config
from prego_tpu_torch.models.llama.layers import apply_rope, dense
from prego_tpu_torch.ops.fused_ffn import rms_norm

Params = Dict[str, torch.Tensor]


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    """YaRN's ``yarn_find_correction_dim``."""
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(config: DeepseekV2Config) -> torch.Tensor:
    """The rotary part's inverse frequencies (dr / 2,), f64: a linear ramp
    between the interpolated 1 / (factor theta^(2i/dr)) and the original
    1 / theta^(2i/dr), between the correction dims of beta_fast and
    beta_slow at the original length (DeepseekV2YarnRotaryEmbedding)."""
    dr, base = config.qk_rope_head_dim, config.rope_theta
    exps = torch.arange(0, dr, 2, dtype=torch.float64) / dr
    extra = 1.0 / base ** exps
    inter = 1.0 / (config.rope_factor * base ** exps)
    low = max(math.floor(_correction_dim(config.rope_beta_fast, dr, base,
                                         config.rope_original_max_position)), 0)
    high = min(math.ceil(_correction_dim(config.rope_beta_slow, dr, base,
                                         config.rope_original_max_position)), dr - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dr // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp  # 1 where the original frequency is kept
    return inter * (1.0 - keep) + extra * keep


def yarn_tables(config: DeepseekV2Config, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (2 * max_seq_len, dr / 2), f32, scaled by
    mscale / mscale_all_dim (``precompute_rope``'s shape)."""
    inv = yarn_inv_freq(config).to(torch.float32).to(device)
    t = torch.arange(2 * config.max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    m = config.rope_cos_scale
    return torch.cos(freqs) * m, torch.sin(freqs) * m


def matrices(config: DeepseekV2Config) -> List[Tuple[str, Tuple[int, int]]]:
    """(name, shape) of one layer's MLA matrices in the serving layout."""
    D, H = config.dim, config.n_heads
    dn, dr, dv, R = (config.qk_nope_head_dim, config.qk_rope_head_dim, config.v_head_dim,
                     config.kv_lora_rank)
    return [("wqkv_a", (D, H * (dn + dr) + dr + R)), ("wkv_b", (R, H * (dn + dv))),
            ("wo", (H * dv, D))]


def init_cache(config: DeepseekV2Config, batch: int, dtype, device, spare: int = 0):
    """Per-layer latent cache: "k" c_kv (B, 1, T, R), "v" k_pe (B, 1, T, dr)."""
    T = config.max_seq_len + spare

    def leaf(width):
        return torch.zeros(batch, 1, T, width, dtype=dtype, device=device)

    return {"k": [leaf(config.kv_lora_rank) for _ in range(config.n_layers)],
            "v": [leaf(config.qk_rope_head_dim) for _ in range(config.n_layers)]}


def attention_mask(start_pos, S: int, T: int, mask, valid) -> Tuple[Optional[torch.Tensor], int]:
    """(a mask broadcastable to scores (B, S, H, keys), keys): the keys a
    forward reads and which of them each query sees, made once a forward
    from ``_cache_index``'s mask or the decode bound ``valid``. A scalar
    position reads its first start_pos + S keys (a decode step all of them
    unmasked); per row, all T keys under each row's mask."""
    if not isinstance(start_pos, torch.Tensor):
        keys = start_pos + S
        return (None if S == 1 else mask[None, :, None, :keys]), keys
    if S == 1:
        k_pos = torch.arange(T, device=valid.device)
        return (k_pos[None, :] < valid[:, None])[:, None, None, :], T
    return mask[:, 0, 0, :, None, :], T  # (B, 1, 1, S, T) -> (B, S, 1, T)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with f32 results: bf16 operands on the card through a
    bf16 GEMM with an f32 output, elsewhere widened exactly to f32 first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def attention(
    p: Params,
    h: torch.Tensor,  # (B, S, D) pre-norm residual stream
    norm_weight: torch.Tensor,
    where,  # where this step's latents go in the cache (``_cache_index``)
    mask: Optional[torch.Tensor],  # from ``attention_mask``
    keys: int,  # the cache positions this forward reads
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_c: torch.Tensor,  # (B, 1, T, R), written in place
    cache_r: torch.Tensor,  # (B, 1, T, dr), written in place
    config: DeepseekV2Config,
) -> torch.Tensor:
    """Returns h + MLA(rms_norm(h)), writing this step's c_kv and k_pe into
    the cache at ``where``."""
    B, S, D = h.shape
    H = config.n_heads
    dn, dr, dv, R = (config.qk_nope_head_dim, config.qk_rope_head_dim, config.v_head_dim,
                     config.kv_lora_rank)
    N = B * S
    x = rms_norm(h, norm_weight, config.norm_eps)
    dt = x.dtype
    qkv = dense(x, p["wqkv_a"]).to(dt)
    q_nope = qkv[..., :H * dn]
    pe = apply_rope(qkv[..., H * dn:H * dn + (H + 1) * dr].reshape(B, S, H + 1, dr), cos, sin)
    c_kv = rms_norm(qkv[..., H * dn + (H + 1) * dr:], p["kv_norm"], config.norm_eps)
    k_pe = pe[:, :, H]

    for cache, new, width in ((cache_c, c_kv, R), (cache_r, k_pe, dr)):
        if isinstance(where, torch.Tensor):  # rows of the flattened (B * T, width) cache
            cache.view(-1, width).index_copy_(0, where, new.reshape(-1, width).to(cache.dtype))
        else:
            cache[:, 0, where] = new.to(cache.dtype)

    # the absorbed form: W_UK and W_UV read in place from W_kvb (R, H, dn + dv)
    wkv_b = p["wkv_b"].view(R, H, dn + dv)
    q_lat = _bmm_f32(q_nope.reshape(N, H, dn).transpose(0, 1),
                     wkv_b[..., :dn].permute(1, 2, 0))  # (H, N, R)
    q_lat = q_lat.to(dt).transpose(0, 1).reshape(B, S * H, R)
    q_pe = pe[:, :, :H].reshape(B, S * H, dr)
    lat = cache_c[:, 0, :keys]  # (B, keys, R)
    scores = (_bmm_f32(q_lat, lat.transpose(1, 2))
              + _bmm_f32(q_pe, cache_r[:, 0, :keys].transpose(1, 2))) * config.softmax_scale
    if mask is not None:
        scores = scores.view(B, S, H, keys).masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dt).view(B, S * H, keys)
    o_lat = _bmm_f32(probs, lat).to(dt)  # (B, S H, R)
    o = _bmm_f32(o_lat.view(N, H, R).transpose(0, 1), wkv_b[..., dn:].transpose(0, 1))
    o = o.to(dt).transpose(0, 1).reshape(B, S, H * dv)  # (H, N, dv) -> (B, S, H dv)
    return h + dense(o, p["wo"]).to(dt)
