"""LLaMA decoder in PyTorch (port of prego_tpu/models/llama/model.py:
bf16, int8 weights, int8 x int8 projections and an int8 KV cache).

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

Decode (one token per row) runs the ported kernels, chosen in the JAX
package's order (prego_tpu/models/llama/model.py:435-455, 487-518,
566-602, 637-656, 678-699, 777-812, 933-953) by its four bf16 fusion gates
and two int8 fusion gates, read from the environment once per ``forward``
call with the JAX package's defaults (``fusion_gates``):

  PREGO_FUSED_ATTN_WO (on)     K8: attention and the wo projection in one
                               call, for a bf16 wo of at most 4.5M elements
                               (the 1B-class shapes; 7B's 4096^2 keeps K2)
  PREGO_FUSED_LAYER (on)       the residual add inside the kernels: K8 with
                               its residual epilogue, and K7a
  PREGO_FUSED_FFN (on)         K7a, the FFN sub-layer with its norm and
                               residual; under PREGO_FUSED_LAYER=0, K7, the
                               FFN alone, after a separate rms_norm
  PREGO_FUSED_CACHE_UPD (off)  K8u: this token's cache write inside K8 with
                               the residual (with the two gates above on)
  PREGO_FUSED_DENSE_Q8 (off)   K9 on weight-only int8 leaves: the attention
                               norm inside the wqkv projection and the
                               residual add inside wo's (decode rows), and
                               the final norm inside the lm-head (B * S <=
                               64 rows, prefill included)
  PREGO_FUSED_FFN_Q8 (off)     K7q, the FFN sub-layer over a weight-only
                               int8 w13 / w2, with its norm and residual
                               (decode rows; needs PREGO_FUSED_LAYER too)

So a 1B-class bf16 decode layer runs K8-res and K7a by default, K8 (f32
out, then the cast and the add) and rms_norm + K7 under
PREGO_FUSED_LAYER=0, K8u and K7a under PREGO_FUSED_CACHE_UPD=1, and K2,
the wo product and the add under PREGO_FUSED_ATTN_WO=0. An int8 KV cache
is tested first, so K3 runs over it whatever the gates say; an int8 wo
never takes K8 or K8u. With both int8 gates on, a weight-only int8 decode
layer runs K9 (norm + wqkv), K3 or K2, K9 (wo + residual) and K7q, and the
step ends in K9 (norm + lm-head); int8 x int8 leaves (``"act"``) and
bf16 leaves never take K9 or K7q, and the unfused layout (wq / wk / wv,
w1 / w3) has no norm + qkv site and no K7q (its int8 wo and lm-head take
K9, as in the JAX package). The JAX package also requires its
``_flash_decode_supported`` (a TPU backend, hd % 128 == 0, max_seq_len %
256 == 0) before any decode kernel; the port's decode branch has no such
condition (K2 runs at every decode step), and K8 takes the same: the
wrappers raise on the card for what the kernels cannot take (R > 8, hd
not a multiple of 16 or above 256, D not a multiple of 8). The dispatch is
the same on the CPU, where each wrapper runs its plain version.
Prefill attention, bf16 projections and sampling are plain PyTorch, as
they are plain XLA in the JAX package.

DeepSeek-V2 (a ``DeepseekV2Config``, which the JAX package has no
counterpart of) runs through the same ``forward``: ``init_params`` and
``init_cache`` give its tree (laid out by ``latent_layout`` and
``latent_tree``) and latent cache, ``precompute_rope`` its
YaRN tables, and each layer dispatches by kind to multi-head latent
attention (``mla.py``) and to the dense SwiGLU sub-layer (the first
layers, ``_ffn_sublayer`` as for LLaMA) or DeepSeekMoE (``moe.py``, a layer
whose tree holds ``"moe"``). It serves in bf16 on one card: quantization,
the int8 cache and tensor parallelism refuse it. The blocks that the
three share (a projection, the rotary embedding, the SwiGLU FFN) are in
``layers.py``.

Quantized serving (``quantize_params``, ``init_params_quantized``): each
projection leaf becomes ``{"q": int8 (K, N), "s": f32 (1, N)}``, plus an
empty-tuple ``"act"`` marker for int8 x int8 projections. ``_dense``
(``layers.dense``) sends
every such leaf through K4 (weight-only) or ``quantize_activations`` and
K5, at prefill as at decode. The JAX package sends projections with a
dimension of 4096 or more to an XLA dot on the TPU (``_q8_dense_backend``,
``PREGO_Q8_DENSE``); that is a TPU choice and is not ported: on the card
every int8 projection runs K4 or K5, or inside K9 or K7q. int8 FFN
weights take the unfused sequence (K7a is bf16 only) unless
``PREGO_FUSED_FFN_Q8`` sends them to K7q. ``init_cache(quantized=True)``
stores K and V as ``{"q": int8 (B, KV, T, hd), "s": f32 (B, KV, T)}``,
one symmetric scale per position and head; decode reads it with K3 and
prefill dequantizes it for the masked einsum.

Tensor parallelism (a ``TensorParallelConfig``'s ``tp_group``, from
``parallel/sharding.py::llama_tp_config``): a rank holds its blocks of the
unfused tree and its kv heads of every cache, and runs the same code on
them with the collectives over the tp group (the fairscale layout, which
the JAX package leaves to XLA's partitioner): the embedding's dim blocks
are all-gathered, the partial products of the row-parallel wo and w2 are
all-reduced in f32 before the cast and the residual add (an int8 x int8
leaf's per-token amax all-reduced (max) before quantizing), and the
logits all-gathered over the vocabulary; a dim the tp size does not
divide stays whole and takes no collective. The fused kernels stay off,
as every kernel does under the JAX package's ``tp_serving`` (K7a, K7,
K7q, K8, K8u and K9 put the norm or the residual inside a row-parallel
product); the kernels that compute the same function on a shard run:
K2, or K3 over an int8 cache, on the rank's kv heads, and K4 and K5 on
its slices. Every rank gets the same logits, so the same sampler seed
draws the same tokens on every rank.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from prego_tpu_torch.models.llama import mla, moe
from prego_tpu_torch.models.llama.config import LlamaConfig, is_latent, refuse_latent
from prego_tpu_torch.models.llama.layers import apply_rope, is_quantized
from prego_tpu_torch.models.llama.layers import dense as _dense
from prego_tpu_torch.models.llama.layers import feed_forward as _feed_forward
from prego_tpu_torch.ops.decode_attention import decode_attention
from prego_tpu_torch.ops.decode_attention_q8 import decode_attention_q8
from prego_tpu_torch.ops.decode_attention_wo import (
    decode_attention_wo, decode_attention_wo_res_upd,
)
from prego_tpu_torch.ops.dense import bmm_f32
from prego_tpu_torch.ops.fused_dense import fused_dense_q8
from prego_tpu_torch.ops.fused_ffn import fused_ffn_block, fused_ffn_block_q8, rms_norm
from prego_tpu_torch.ops.quant import quantize_weight

Params = Dict[str, Any]
# {"k": [per-layer], "v": [per-layer]}; a layer's leaf is a tensor, or
# {"q": int8, "s": f32} in a quantized cache
Cache = Dict[str, List[Any]]

__all__ = [
    "init_params", "init_params_quantized", "quantize_params", "fuse_projections",
    "init_cache", "clone_cache", "load_rows", "rms_norm", "precompute_rope", "apply_rope",
    "forward",
]


# the largest wo that K8 / K8u take: the JAX kernel keeps wo resident in
# VMEM beside the K/V buffers (model.py:582), and the port keeps its gate
WO_FUSE_MAX = 4_500_000


class FusionGates(NamedTuple):
    """The decode fusion gates, as the JAX package reads them."""

    ffn: bool  # PREGO_FUSED_FFN: K7a (and K7 under layer=False)
    attn_wo: bool  # PREGO_FUSED_ATTN_WO: K8
    layer: bool  # PREGO_FUSED_LAYER: residual epilogues (K8-res, K7a, K7q)
    cache_upd: bool  # PREGO_FUSED_CACHE_UPD: K8u
    dense_q8: bool  # PREGO_FUSED_DENSE_Q8: K9 (norm + wqkv, wo + residual, norm + lm-head)
    ffn_q8: bool  # PREGO_FUSED_FFN_Q8: K7q


def _fused_ffn_supported() -> bool:
    return os.environ.get("PREGO_FUSED_FFN", "1") != "0"  # kill switch


def _fused_attn_wo_supported() -> bool:
    return os.environ.get("PREGO_FUSED_ATTN_WO", "1") != "0"  # kill switch


def _fused_layer_supported() -> bool:
    return os.environ.get("PREGO_FUSED_LAYER", "1") != "0"  # kill switch


def _fused_cache_upd_supported() -> bool:
    return os.environ.get("PREGO_FUSED_CACHE_UPD", "0") == "1"  # opt-in


def _fused_dense_q8_supported() -> bool:
    return os.environ.get("PREGO_FUSED_DENSE_Q8", "0") == "1"  # opt-in


def _fused_ffn_q8_supported() -> bool:
    return os.environ.get("PREGO_FUSED_FFN_Q8", "0") == "1"  # opt-in


def fusion_gates() -> FusionGates:
    return FusionGates(_fused_ffn_supported(), _fused_attn_wo_supported(),
                       _fused_layer_supported(), _fused_cache_upd_supported(),
                       _fused_dense_q8_supported(), _fused_ffn_q8_supported())


# under tensor parallelism: the unfused sequence everywhere
TP_GATES = FusionGates(False, False, False, False, False, False)


def _weight_only_q8(leaf) -> bool:
    """An int8 leaf without the int8 x int8 marker: the leaves K9 and K7q take."""
    return is_quantized(leaf) and "act" not in leaf


# ---- initialization ----

def init_params(
    config: LlamaConfig, generator: torch.Generator, dtype=torch.bfloat16, device="cpu"
) -> Params:
    """Random init, normal scaled by 1/sqrt(d_in) (the JAX package's
    distribution; its draws differ). Real weights come from a converter.
    A ``DeepseekV2Config`` gets its serving tree (``latent_tree``)."""
    D, V, F = config.dim, config.vocab_size, config.ffn_hidden
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim

    def dense(d_in, d_out):
        w = torch.randn(d_in, d_out, generator=generator, device=device, dtype=torch.float32)
        return (w * d_in ** -0.5).to(dtype)

    def ones():
        return torch.ones(D, dtype=dtype, device=device)

    if is_latent(config):
        def draw(shape):
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            return (w * shape[-2] ** -0.5).to(dtype)

        return latent_tree(config, [draw(shape) for _, shape in latent_layout(config)],
                           draw((V, D)), dtype, device)

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


def latent_layout(config) -> List[Tuple[Tuple[Any, ...], Tuple[int, ...]]]:
    """(path in the tree, shape) of every matrix of DeepSeek-V2's serving
    tree but the embedding, in the order ``latent_tree`` takes them: each
    layer's MLA (``mla.matrices``), then its dense SwiGLU (fused w13 = w1 |
    w3) before ``first_k_dense_replace`` or its DeepSeekMoE
    (``moe.matrices``), then the lm-head. A matrix's input width is
    ``shape[-2]``."""
    D, F = config.dim, config.ffn_hidden
    out = []
    for i in range(config.n_layers):
        out += [(("layers", i, "attention", name), shape)
                for name, shape in mla.matrices(config)]
        if config.is_moe_layer(i):
            out += [(("layers", i, "moe") + path, shape) for path, shape in moe.matrices(config)]
        else:
            out += [(("layers", i, "feed_forward", "w13"), (D, 2 * F)),
                    (("layers", i, "feed_forward", "w2"), (F, D))]
    return out + [(("output",), (D, config.vocab_size))]


def latent_tree(config, matrices: Sequence[torch.Tensor], embedding: torch.Tensor,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """DeepSeek-V2's serving tree of its matrices, in ``latent_layout``'s
    order, and its embedding (V, D); every norm 1."""
    def ones(n=config.dim):
        return torch.ones(n, dtype=dtype, device=device)

    layers = [{"attention": {"kv_norm": ones(config.kv_lora_rank)}, "attention_norm": ones(),
               "ffn_norm": ones()} for _ in range(config.n_layers)]
    tree = {"tok_embeddings": embedding, "layers": layers, "norm": ones()}
    layout = latent_layout(config)
    if len(matrices) != len(layout):
        raise ValueError(f"DeepSeek-V2's tree takes {len(layout)} matrices, not {len(matrices)}")
    for (path, _), w in zip(layout, matrices):
        node = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = w
    return tree


def init_params_quantized(
    config: LlamaConfig, generator: torch.Generator, fused: bool = True,
    dtype=torch.bfloat16, device="cpu", activations: bool = False,
) -> Params:
    """Random int8 weights drawn directly, without a bf16 model first
    (prego_tpu/models/llama/model.py::init_params_quantized): each
    projection is {"q": int8 uniform in [-127, 127], "s": f32 (1, N)} with
    the scale set so that q * s has the RMS 1/sqrt(d_in) of ``init_params``
    (an int8 uniform has RMS ~73.3). ``fused`` gives the serving layout
    (wqkv, w13); ``activations`` adds the int8 x int8 marker. Embeddings
    and norms are ``dtype``."""
    D, V, F = config.dim, config.vocab_size, config.ffn_hidden
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim

    def qdense(d_in, d_out):
        q = torch.randint(-127, 128, (d_in, d_out), generator=generator, device=device,
                          dtype=torch.int8)
        s = torch.full((1, d_out), 1.0 / (73.3 * d_in ** 0.5), dtype=torch.float32,
                       device=device)
        return {"q": q, "s": s, **({"act": ()} if activations else {})}

    def ones():
        return torch.ones(D, dtype=dtype, device=device)

    layers = []
    for _ in range(config.n_layers):
        if fused:
            attention = {"wqkv": qdense(D, (H + 2 * KV) * hd), "wo": qdense(H * hd, D)}
            ff = {"w13": qdense(D, 2 * F), "w2": qdense(F, D)}
        else:
            attention = {"wq": qdense(D, H * hd), "wk": qdense(D, KV * hd),
                         "wv": qdense(D, KV * hd), "wo": qdense(H * hd, D)}
            ff = {"w1": qdense(D, F), "w2": qdense(F, D), "w3": qdense(D, F)}
        layers.append({"attention": attention, "feed_forward": ff,
                       "attention_norm": ones(), "ffn_norm": ones()})
    emb = torch.randn(V, D, generator=generator, device=device, dtype=torch.float32)
    return {
        "tok_embeddings": (emb * V ** -0.5).to(dtype),
        "layers": layers,
        "norm": ones(),
        "output": qdense(D, V),
    }


def quantize_params(params: Params, activations: bool = False) -> Params:
    """Per-output-channel int8 for every projection and the lm-head;
    embeddings and norms stay as they are. ``activations`` marks the
    leaves for int8 x int8 products. A DeepSeek-V2 tree is refused."""
    if "wqkv_a" in params["layers"][0]["attention"]:
        raise ValueError("quantize_params does not take the MLA/MoE configuration "
                         "(DeepseekV2Config): it serves the LLaMA block only")

    def quant(w):
        q, s = quantize_weight(w)
        return {"q": q, "s": s, **({"act": ()} if activations else {})}

    return {
        "tok_embeddings": params["tok_embeddings"],
        "norm": params["norm"],
        "output": quant(params["output"]),
        "layers": [
            {
                "attention": {k: quant(v) for k, v in layer["attention"].items()},
                "feed_forward": {k: quant(v) for k, v in layer["feed_forward"].items()},
                "attention_norm": layer["attention_norm"],
                "ffn_norm": layer["ffn_norm"],
            }
            for layer in params["layers"]
        ],
    }


def mark_activations(params: Params, activations: bool) -> Params:
    """The same int8 tensors with the int8 x int8 marker set (or removed)
    on every quantized leaf."""
    if is_quantized(params):
        return {"q": params["q"], "s": params["s"], **({"act": ()} if activations else {})}
    if isinstance(params, dict):
        return {k: mark_activations(v, activations) for k, v in params.items()}
    if isinstance(params, list):
        return [mark_activations(v, activations) for v in params]
    return params


def _concat(leaves):
    """Concatenate projections along the output dim; int8 leaves keep
    their per-column scales, so the result is the quantization of the
    concatenated weight."""
    if is_quantized(leaves[0]):
        out = {"q": torch.cat([l["q"] for l in leaves], dim=1),
               "s": torch.cat([l["s"] for l in leaves], dim=1)}
        return {**out, "act": ()} if "act" in leaves[0] else out
    return torch.cat(leaves, dim=1)


def fuse_projections(params: Params) -> Params:
    """Serving layout: wq|wk|wv -> wqkv and w1|w3 -> w13, one projection
    product each on the decode path. Composes with quantization in either
    order (per-column scales concatenate)."""
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
                "attention": {"wqkv": _concat([a["wq"], a["wk"], a["wv"]]), "wo": a["wo"]},
                "feed_forward": {"w13": _concat([f["w1"], f["w3"]]), "w2": f["w2"]},
                "attention_norm": layer["attention_norm"],
                "ffn_norm": layer["ffn_norm"],
            }
        )
    return out


def init_cache(
    config: LlamaConfig, batch: int, dtype=torch.bfloat16, device="cpu", quantized: bool = False,
    spare: int = 0,
) -> Cache:
    """Per-layer head-major (B, KV, T, hd) K and V tensors, T = max_seq_len
    + ``spare`` (speculative decoding's spare tail); ``quantized``:
    {"q": (B, KV, T, hd) int8, "s": (B, KV, T) f32} leaves instead, half
    the cache bytes of bf16. Under tensor parallelism, this rank's kv
    heads only. A ``DeepseekV2Config`` gets its latent cache (``mla.py``)."""
    if is_latent(config):
        if quantized:
            refuse_latent(config, "the int8 KV cache")
        return mla.init_cache(config, batch, dtype, device, spare)
    shape = (batch, config.kv_heads // config.tp_size, config.max_seq_len + spare,
             config.head_dim)

    def leaf():
        if quantized:
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
        return torch.zeros(shape, dtype=dtype, device=device)

    return {key: [leaf() for _ in range(config.n_layers)] for key in ("k", "v")}


def clone_cache(cache: Cache, batch: Optional[int] = None) -> Cache:
    """A copy of ``cache``; with ``batch``, its B=1 rows repeated to that
    batch."""

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return t.clone() if batch is None else t.repeat(batch, *([1] * (t.ndim - 1)))

    return {key: [copy(t) for t in cache[key]] for key in ("k", "v")}


def load_rows(cache: Cache, batch: int, length: int, prefix: Optional[Cache] = None) -> Cache:
    """The cache of ``batch`` rows and ``length`` positions that starts each
    leaf's memory in ``cache`` (a store of at least that many rows and
    positions), loaded in place: ``prefix``'s B=1 row broadcast over its
    positions and zeros past them, or zeros where ``prefix`` is None. Every
    position a row can read is rewritten, and a call of the same ``batch``
    and ``length`` finds the same addresses as the one before it."""

    def rows(dst, src):
        if isinstance(dst, dict):
            return {k: rows(dst[k], None if src is None else src[k]) for k in dst}
        shape = (batch, dst.shape[1], length, *dst.shape[3:])
        out = dst.view(-1)[: math.prod(shape)].view(shape)
        n = 0 if src is None else src.shape[2]
        if n:
            out[:, :, :n].copy_(src.expand(batch, *src.shape[1:]))
        out[:, :, n:].zero_()
        return out

    srcs = prefix or {key: [None] * len(cache[key]) for key in ("k", "v")}
    return {key: [rows(dst, src) for dst, src in zip(cache[key], srcs[key])]
            for key in ("k", "v")}


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, KV, S, hd) -> (int8 values, (B, KV, S) f32 symmetric scales)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _kv_dequant(leaf: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """An int8 cache leaf as ``dtype`` values (the prefill einsum's input)."""
    return (leaf["q"].float() * leaf["s"][..., None]).to(dtype)


def _rows(leaf) -> int:
    """K of a (K, N) projection leaf, plain or int8."""
    return (leaf["q"] if is_quantized(leaf) else leaf).shape[0]


def _cols(leaf) -> int:
    """N of a (K, N) projection leaf, plain or int8."""
    return (leaf["q"] if is_quantized(leaf) else leaf).shape[1]


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``dim``, concatenated in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


# ---- building blocks ----

def precompute_rope(config: LlamaConfig, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (2 * max_seq_len, head_dim // 2), f32; for a
    ``DeepseekV2Config`` YaRN's over its rotary part (``mla.yarn_tables``)."""
    if is_latent(config):
        return mla.yarn_tables(config, device)
    hd = config.head_dim
    inv_freq = 1.0 / (
        config.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    )
    t = torch.arange(2 * config.max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def _project_qkv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) times wqkv, or wq | wk | wv, in x's dtype."""
    if "wqkv" in p:
        return _dense(x, p["wqkv"]).to(x.dtype)
    return torch.cat([_dense(x, p[w]).to(x.dtype) for w in ("wq", "wk", "wv")], dim=-1)


def _split_heads(xqkv: torch.Tensor, H: int, KV: int, hd: int, cos, sin):
    """(q (B, S, KV, H / KV, hd), the new K and V (B, KV, S, hd)) of a
    projection (B, S, (H + 2 KV) hd), the rope applied to q and K."""
    B, S = xqkv.shape[:2]
    # q and k heads rotate together: one rope pass over H + KV heads
    qk = apply_rope(xqkv[..., : (H + KV) * hd].reshape(B, S, H + KV, hd), cos, sin)
    xq, xk = qk[:, :, :H], qk[:, :, H:]
    xv = xqkv[..., (H + KV) * hd :].reshape(B, S, KV, hd)
    return xq.reshape(B, S, KV, H // KV, hd), xk.transpose(1, 2), xv.transpose(1, 2)


def _masked_attention(q: torch.Tensor, k_full: torch.Tensor, v_full: torch.Tensor,
                      mask: torch.Tensor, dt) -> torch.Tensor:
    """GQA of q (B, S, KV, R, hd) against whole (B, KV, T, hd) K and V under
    ``mask`` (model.py:612-636): f32 scores, softmax, the product with V.
    (B, S, KV R hd) in ``dt``."""
    B, S, KV, R, hd = q.shape
    qh = q.permute(0, 2, 3, 1, 4)  # (B, KV, R, S, hd)
    scores = bmm_f32(qh, k_full[:, :, None].transpose(-1, -2)) / (hd ** 0.5)
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = bmm_f32(probs, v_full[:, :, None]).to(dt)  # (B, KV, R, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, KV * R * hd)


def _attention(
    p: Params,
    h: torch.Tensor,  # (B, S, D) pre-norm residual stream
    norm_weight: torch.Tensor,
    where,  # where this step's K/V go in the cache (``_cache_index``)
    mask: Optional[torch.Tensor],  # S > 1: the causal mask over the cache
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache_k,  # (B, KV, T, hd) tensor or int8 {"q", "s"} leaf, written in place
    cache_v,
    config: LlamaConfig,
    valid: Optional[torch.Tensor],  # (B,) int32 decode bound, start_pos + 1
    pos: Optional[torch.Tensor],  # (B,) int32 decode position, start_pos (for K8u)
    gates: FusionGates,
) -> torch.Tensor:
    """Returns h + attention(rms_norm(h)), writing this step's K/V into
    the cache at ``where``. Under tensor parallelism, over this rank's
    heads, with wo's partial products summed over the tp group."""
    B, S, D = h.shape
    tp = config.tp_size
    H, KV, hd = config.n_heads // tp, config.kv_heads // tp, config.head_dim
    dense_q8 = S == 1 and gates.dense_q8  # K9's decode sites
    if dense_q8 and _weight_only_q8(p.get("wqkv")):
        # the norm inside the int8 qkv projection
        dt = h.dtype
        xqkv = fused_dense_q8(h.reshape(B, D), p["wqkv"]["q"], p["wqkv"]["s"],
                              norm_weight=norm_weight, eps=config.norm_eps,
                              out_dtype=dt).reshape(B, 1, -1)
    else:
        x = rms_norm(h, norm_weight, config.norm_eps)
        dt = x.dtype
        xqkv = _project_qkv(p, x)
    q, k_new, v_new = _split_heads(xqkv, H, KV, hd, cos, sin)

    kv_quant = isinstance(cache_k, dict)
    per_row = isinstance(where, torch.Tensor)
    wo = p["wo"]
    # K8 and K8u: a bf16 wo small enough, over a bf16 cache; the JAX
    # package keeps them to scalar positions (model.py:488, 580)
    fuse_wo = (S == 1 and not kv_quant and not per_row and not is_quantized(wo)
               and wo.numel() <= WO_FUSE_MAX and gates.attn_wo)
    if fuse_wo and gates.layer and gates.cache_upd:
        # the whole tail in one call: cache write, attention, wo, residual
        h_next, _, _ = decode_attention_wo_res_upd(
            q[:, 0].contiguous(), h, k_new.to(cache_k.dtype), v_new.to(cache_v.dtype),
            cache_k, cache_v, pos, wo)
        return h_next

    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        if kv_quant:  # one scale per new position and head
            nq, ns = _kv_quantize(new)
            if per_row:  # rows of the flattened (B * KV * T, hd) cache
                cache["q"].view(-1, hd).index_copy_(0, where, nq.reshape(-1, hd))
                cache["s"].view(-1).index_copy_(0, where, ns.reshape(-1))
            else:
                cache["q"][:, :, where], cache["s"][:, :, where] = nq, ns
        elif per_row:
            cache.view(-1, hd).index_copy_(0, where, new.to(cache.dtype).reshape(-1, hd))
        else:
            cache[:, :, where] = new.to(cache.dtype)

    if S == 1:
        # one token per row: the bounded decode kernels (K3 over int8, K8, K2)
        q1 = q[:, 0].contiguous()
        if kv_quant:
            out = decode_attention_q8(q1, cache_k["q"], cache_k["s"], cache_v["q"],
                                      cache_v["s"], valid)
        elif fuse_wo:
            if gates.layer:  # the residual add in the kernel's epilogue
                return decode_attention_wo(q1, cache_k, cache_v, valid, wo, residual=h)
            return h + decode_attention_wo(q1, cache_k, cache_v, valid, wo).to(dt)
        else:
            out = decode_attention(q1, cache_k, cache_v, valid)
        out = out.reshape(B, 1, H * hd).to(dt)
        if dense_q8 and _weight_only_q8(wo):
            # the int8 wo projection and the residual add in one call
            return fused_dense_q8(out.reshape(B, H * hd), wo["q"], wo["s"],
                                  residual=h.reshape(B, D)).reshape(B, 1, D)
    else:
        # GQA against the full cache with a causal mask (model.py:612-636);
        # an int8 cache is dequantized for it
        k_full = _kv_dequant(cache_k, dt) if kv_quant else cache_k
        v_full = _kv_dequant(cache_v, dt) if kv_quant else cache_v
        out = _masked_attention(q, k_full, v_full, mask, dt)
    return h + _dense(out, wo, _row_group(wo, config.n_heads * hd, config)).to(dt)


def _split(n_local: int, n_whole: int, config: LlamaConfig) -> bool:
    """Whether a dim of ``n_whole`` is split over the tp group, ``n_local``
    its block here (a dim the tp size does not divide stays whole; over
    one rank the block is the whole, and the collectives still run)."""
    return _tp_group(config) is not None and n_local * config.tp_size == n_whole


def _tp_group(config: LlamaConfig):
    """The tp process group of a ``TensorParallelConfig``, else None."""
    return getattr(config, "tp_group", None)


def _row_group(leaf, k_whole: int, config: LlamaConfig):
    """The tp group where a row-parallel leaf holds a block of its ``k_whole``
    rows, else None."""
    return _tp_group(config) if _split(_rows(leaf), k_whole, config) else None


def _cache_index(start_pos, B: int, S: int, KV: int, T: int, device):
    """Where a step writes the cache and, for S > 1, its causal mask over the
    cache's T positions (model.py:612-636), made once per forward. Scalar:
    the position slice and an (S, T) mask. Per row: the (B * KV * S,) rows
    of the flattened (B * KV * T, hd) cache in (b, kv, s) order, each start
    clamped to the cache as the JAX package's dynamic_update_slice does,
    and a (B, 1, 1, S, T) mask at each row's own offset."""
    per_row = isinstance(start_pos, torch.Tensor)
    steps = torch.arange(S, device=device) if per_row or S > 1 else None
    if per_row:
        span = torch.clamp(start_pos.long(), 0, T - S)[:, None] + steps[None, :]  # (B, S)
        heads = torch.arange(B * KV, device=device).view(B, KV, 1) * T
        where = (heads + span[:, None, :]).reshape(-1)
    else:
        where = slice(start_pos, start_pos + S)
    if S == 1:
        return where, None
    k_pos = torch.arange(T, device=device)
    if per_row:
        return where, (k_pos <= start_pos[:, None, None] + steps[None, :, None])[:, None, None]
    return where, k_pos <= start_pos + steps[:, None]


def _ffn_sublayer(
    layer: Params, h: torch.Tensor, config: LlamaConfig, gates: FusionGates
) -> torch.Tensor:
    """h + ffn(rms_norm(h, ffn_norm)). Decode rows in the fused layout run
    the K7a wrapper (bf16 weights, with the FFN and layer gates on) or the
    K7q wrapper (weight-only int8, with the int8 FFN and layer gates on);
    everything else runs the op sequence, which may reach K7."""
    p = layer["feed_forward"]
    nw = layer["ffn_norm"]
    B, S, D = h.shape
    if "w13" in p and not is_quantized(p["w13"]) and S == 1 and gates.ffn and gates.layer:
        return fused_ffn_block(h.reshape(B, D), nw, p["w13"], p["w2"], config.norm_eps).reshape(
            B, 1, D
        )
    if "w13" in p and _weight_only_q8(p["w13"]) and S == 1 and gates.ffn_q8 and gates.layer:
        w13, w2 = p["w13"], p["w2"]
        return fused_ffn_block_q8(h.reshape(B, D), nw, w13["q"], w13["s"], w2["q"], w2["s"],
                                  config.norm_eps).reshape(B, 1, D)
    group = _row_group(p["w2"], config.ffn_hidden, config)
    return h + _feed_forward(p, rms_norm(h, nw, config.norm_eps), gates, group)


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, S) int64
    start_pos,  # int, or a (B,) int32 tensor on tokens' device
    cache: Cache,
    config: LlamaConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    moe_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Decoder forward. Returns (f32 logits (B, S, V), the cache, updated
    in place).

    ``start_pos`` is a Python int (every row at the same cache offset) or
    a (B,) tensor of per-row positions (prego_tpu/models/llama/model.py:
    894-912), the continuous-batching path, where each slot of a shared
    cache advances on its own: rope rows are gathered per row, the cache
    is written per row by index, decode attention is bounded per row and
    the masked path masks per row, all on the device (no host read). K8
    and K8u are skipped per row, as in the JAX package; with every entry
    equal the result is the scalar path's, bit for bit.

    Under tensor parallelism (a ``TensorParallelConfig``) ``params`` are this
    rank's blocks and ``cache`` its kv heads; the logits come back whole
    on every rank.

    A ``DeepseekV2Config`` runs MLA over its latent cache in every layer,
    then the dense FFN sub-layer or DeepSeekMoE; ``moe_counts`` (n_moe_layers,
    n_routed_experts) int32, where given, receives each MoE layer's expert
    offsets (``moe.routed_experts``)."""
    if rope is None:
        rope = precompute_rope(config, device=tokens.device)
    cos_full, sin_full = rope
    B, S = tokens.shape
    per_row = isinstance(start_pos, torch.Tensor)
    if per_row:
        if tuple(start_pos.shape) != (B,):
            raise ValueError(f"forward: per-row start_pos must be ({B},), got "
                             f"{tuple(start_pos.shape)}")
        pos_ids = start_pos.long()[:, None] + torch.arange(S, device=tokens.device)[None, :]
        cos, sin = cos_full[pos_ids], sin_full[pos_ids]  # (B, S, hd/2)
    else:
        cos = cos_full[start_pos : start_pos + S]
        sin = sin_full[start_pos : start_pos + S]
    emb = params["tok_embeddings"]
    V = emb.shape[0]
    # negative ids (the -1 pad) wrap like jnp.take's index normalisation
    h = emb[torch.where(tokens < 0, tokens + V, tokens)]
    tp = _tp_group(config)
    if _split(emb.shape[1], config.dim, config):  # ParallelEmbedding's dim blocks
        h = _all_gather(h, -1, tp)
    gates = fusion_gates() if tp is None else TP_GATES  # once per call, not per layer
    if tp is not None and params["layers"] and "wqkv" in params["layers"][0]["attention"]:
        raise ValueError("tensor-parallel serving takes the unfused layout (wq/wk/wv, "
                         "w1/w3): a block of wqkv or w13 cuts across its q|k|v or gate|up parts")
    leaf = cache["k"][0]
    KV, T = (leaf["q"] if isinstance(leaf, dict) else leaf).shape[1:3]
    where, mask = _cache_index(start_pos, B, S, KV, T, tokens.device)
    valid = pos = None
    if S == 1 and per_row:  # K8u is skipped per row: no pos
        valid = (start_pos + 1).to(torch.int32)
    elif S == 1:
        valid = torch.full((B,), start_pos + 1, dtype=torch.int32, device=tokens.device)
        if gates.cache_upd:
            pos = torch.full((B,), start_pos, dtype=torch.int32, device=tokens.device)
    if is_latent(config):
        return _latent_layers(params, h, start_pos, cache, config, gates, where, mask, valid,
                              cos, sin, T, moe_counts), cache
    for i, layer in enumerate(params["layers"]):
        h = _attention(
            layer["attention"], h, layer["attention_norm"], where, mask, cos, sin,
            cache["k"][i], cache["v"][i], config, valid, pos, gates,
        )
        h = _ffn_sublayer(layer, h, config, gates)
    out_w = params["output"]
    if _weight_only_q8(out_w) and B * S <= 64 and gates.dense_q8:
        # the final norm inside the int8 lm-head (decode, and prefill of up
        # to 64 rows)
        logits = fused_dense_q8(h.reshape(B * S, -1), out_w["q"], out_w["s"],
                                norm_weight=params["norm"], eps=config.norm_eps)
        return logits.reshape(B, S, -1), cache
    h = rms_norm(h, params["norm"], config.norm_eps)
    logits = _dense(h, out_w)
    if _split(_cols(out_w), V, config):  # the vocabulary's blocks
        logits = _all_gather(logits, -1, tp)
    return logits, cache


def _latent_layers(params, h, start_pos, cache, config, gates, where, mask, valid, cos, sin,
                   T: int, moe_counts) -> torch.Tensor:
    """DeepSeek-V2's layers and head: f32 logits (B, S, V)."""
    S = h.shape[1]
    mask, keys = mla.attention_mask(start_pos, S, T, mask, valid)
    j = 0
    for i, layer in enumerate(params["layers"]):
        h = mla.attention(layer["attention"], h, layer["attention_norm"], where, mask, keys,
                          cos, sin, cache["k"][i], cache["v"][i], config)
        if "moe" in layer:
            h = moe.sublayer(layer, h, config, gates,
                             None if moe_counts is None else moe_counts[j])
            j += 1
        else:
            h = _ffn_sublayer(layer, h, config, gates)
    return _dense(rms_norm(h, params["norm"], config.norm_eps), params["output"])
