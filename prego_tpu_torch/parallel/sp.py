"""Sequence-parallel (context-parallel) LLaMA prefill (port of
prego_tpu/parallel/sp.py).

A long prompt is split along the sequence over the ranks of a mesh axis:
every rank embeds and projects only its block of S / sp tokens (the
projection and FFN work is token-parallel). Per layer the ranks
all-gather the new K and V over the axis, write the whole span into the
cache, and each attends its own queries causally at their absolute
positions; each rank returns the logits of its own block. The JAX package
states the same with shardings and lets XLA insert the collectives.

The cache comes back in one of three layouts, as in the JAX package:
``"sequence"`` (each rank keeps its block of the max_seq axis, so prefill
memory shrinks with sp), ``"heads"`` (kv heads split, the tensor-parallel
decode layout) or ``"replicated"`` (the whole cache on every rank, for an
unsharded decode). ``gather_cache`` turns a split cache whole again.
Parameters are replicated (every rank holds the whole tree); the cache's
leaves are plain (B, KV, T, hd) tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from prego_tpu_torch.models.llama.config import LlamaConfig
from prego_tpu_torch.models.llama.model import (
    Cache, Params, _all_gather, _dense, _ffn_sublayer, _masked_attention, _project_qkv,
    _split_heads, fusion_gates, precompute_rope, rms_norm,
)
from prego_tpu_torch.parallel.mesh import Mesh

CACHE_SHARDINGS = ("replicated", "sequence", "heads")
# the dim of a (B, KV, T, hd) cache leaf that each split layout cuts
_CACHE_DIM = {"sequence": 2, "heads": 1}


def make_sp_prefill(
    config: LlamaConfig,
    mesh: Mesh,
    axis: str = "sp",
    cache_sharding: str = "sequence",
):
    """A prefill with the sequence split over ``axis``.

    Returns fn(params, tokens (B, S), start_pos, cache) -> (logits, cache):
    ``tokens`` whole on every rank (S divisible by the axis size), the
    logits (B, S / sp, V) of this rank's block, and ``cache`` (whole, its
    leaves written in place) handed back in the ``cache_sharding`` layout."""
    if cache_sharding not in CACHE_SHARDINGS:
        raise ValueError(f"cache_sharding must be one of {CACHE_SHARDINGS}")
    group, n, r = mesh.group(axis), mesh.shape[axis], mesh.index(axis)
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim

    @torch.no_grad()
    def sp_prefill(params: Params, tokens: torch.Tensor, start_pos: int, cache: Cache):
        B, S = tokens.shape
        if S % n:
            raise ValueError(f"sequence of {S} tokens does not split over {axis!r} of size {n}")
        if isinstance(cache["k"][0], dict):
            raise ValueError("sequence-parallel prefill takes a bf16 / f32 cache, not int8")
        Sb = S // n
        dev = tokens.device
        emb = params["tok_embeddings"]
        block = tokens[:, r * Sb:(r + 1) * Sb]
        h = emb[torch.where(block < 0, block + emb.shape[0], block)]
        cos, sin = precompute_rope(config, device=dev)
        positions = start_pos + r * Sb + torch.arange(Sb, device=dev)
        cos, sin = cos[positions], sin[positions]
        T = cache["k"][0].shape[2]
        mask = torch.arange(T, device=dev)[None, :] <= positions[:, None]  # (Sb, T)
        span = slice(start_pos, start_pos + S)
        gates = fusion_gates()
        for i, layer in enumerate(params["layers"]):
            p = layer["attention"]
            x = rms_norm(h, layer["attention_norm"], config.norm_eps)
            q, k_new, v_new = _split_heads(_project_qkv(p, x), H, KV, hd, cos, sin)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, :, span] = _all_gather(k_new, 2, group).to(ck.dtype)
            cv[:, :, span] = _all_gather(v_new, 2, group).to(cv.dtype)
            h = h + _dense(_masked_attention(q, ck, cv, mask, x.dtype), p["wo"]).to(x.dtype)
            h = _ffn_sublayer(layer, h, config, gates)
        logits = _dense(rms_norm(h, params["norm"], config.norm_eps), params["output"])
        if cache_sharding == "replicated":
            return logits, cache
        dim = _CACHE_DIM[cache_sharding]

        def block_of(t):
            if t.shape[dim] % n:
                raise ValueError(f"cache dim {dim} of size {t.shape[dim]} does not split "
                                 f"over {axis!r} of size {n}")
            step = t.shape[dim] // n
            return t.narrow(dim, r * step, step).clone()

        return logits, {key: [block_of(t) for t in cache[key]] for key in ("k", "v")}

    return sp_prefill


def gather_cache(cache: Cache, mesh: Mesh, axis: str = "sp",
                 cache_sharding: str = "sequence") -> Dict[str, Any]:
    """The whole cache from a ``make_sp_prefill`` cache of layout
    ``cache_sharding`` (each rank's blocks all-gathered over ``axis``), for
    the unsharded decode."""
    if cache_sharding not in CACHE_SHARDINGS:
        raise ValueError(f"cache_sharding must be one of {CACHE_SHARDINGS}")
    if cache_sharding == "replicated":
        return cache
    dim, group = _CACHE_DIM[cache_sharding], mesh.group(axis)
    return {key: [_all_gather(t, dim, group) for t in cache[key]] for key in ("k", "v")}
