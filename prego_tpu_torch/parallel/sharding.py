"""Tensor-parallel sharding rules for the LLaMA decoder (port of
prego_tpu/parallel/sharding.py).

The spec trees are the JAX package's, axis for axis: fairscale's
Column/RowParallelLinear and ParallelEmbedding layout
(llama/model.py:202-235, 338-346, 438-449) as ``PartitionSpec`` metadata
on the parameter tree. Weights are stored (in, out):

  wq/wk/wv, w1/w3 : split OUT  -> P(None, 'tp')  (column-parallel)
  wo, w2          : split IN   -> P('tp', None)  (row-parallel)
  tok_embeddings  : split emb  -> P(None, 'tp')  (ParallelEmbedding)
  output head     : split vocab-> P(None, 'tp')
  norms           : replicated
  KV cache        : split kv heads (and the batch over dp)

Where XLA partitions the same math from the specs, here ``shard_params``
hands each rank its own blocks (plain tensors) and the model, given the tp
group through ``llama_tp_config``, calls the collectives itself
(``models/llama/model.py``): the embedding's dim blocks are all-gathered,
wo's and w2's partial products all-reduced before the residual add, the
logits all-gathered over the vocabulary unless the head stayed whole.

Unlike XLA, the port cannot reshard activations between heads, so tp must
divide both n_heads and n_kv_heads (fairscale requires the same), and
tensor-parallel serving takes the unfused layout (wq/wk/wv, w1/w3): the
fused specs below lay out a tree, but a contiguous split of wqkv or w13
cuts across its q|k|v and gate|up blocks, and ``llama_tp_config`` is not
for such a tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from prego_tpu_torch.models.llama.config import LlamaConfig, TensorParallelConfig, refuse_latent
from prego_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P, local_block


def llama_param_specs(
    config: LlamaConfig, tp_axis: str = "tp",
    quantized: bool = False, fused: bool = False,
    activations: bool = False,
) -> Dict[str, Any]:
    """PartitionSpec tree matching the parameter layout (the JAX
    function's tree).

    ``quantized`` matches int8 leaves ({"q": (K, N) int8, "s": (1, N) f32}):
    column-parallel projections split both q and the per-output-channel
    scales on the output dim; row-parallel ones split q on the input dim
    and replicate s. ``activations`` adds the int8 x int8 marker ("act",
    an empty tuple that holds no tensor): the weight split is the same;
    a row-parallel input splits the contraction dim, so its per-token amax
    is all-reduced (max) over tp before quantizing, and the partial
    products, scaled inside K5, are summed in f32 (the JAX package sums
    exact int32 partials and rescales after). ``fused`` matches the fused
    wqkv/w13 layout."""

    def leaf(spec: P, s_spec: P):
        if not quantized:
            return spec
        out = {"q": spec, "s": s_spec}
        if activations:
            out["act"] = ()
        return out

    col = leaf(P(None, tp_axis), P(None, tp_axis))
    row = leaf(P(tp_axis, None), P())
    rep = P()
    if fused:
        attention = {"wqkv": col, "wo": row}
        feed_forward = {"w13": col, "w2": row}
    else:
        attention = {"wq": col, "wk": col, "wv": col, "wo": row}
        feed_forward = {"w1": col, "w2": row, "w3": col}
    layer = {
        "attention": attention,
        "feed_forward": feed_forward,
        "attention_norm": rep,
        "ffn_norm": rep,
    }
    return {
        "tok_embeddings": P(None, tp_axis),
        "layers": [layer for _ in range(config.n_layers)],
        "norm": rep,
        "output": leaf(P(None, tp_axis), P(None, tp_axis)),
    }


def llama_cache_specs(
    config: LlamaConfig, tp_axis: str = "tp", dp_axis: str = None,
    quantized: bool = False,
) -> Dict[str, Any]:
    """Per-layer (B, kv_heads, T, hd) cache leaves: kv heads split over tp;
    with ``dp_axis`` the batch split too (2D dp x tp serving: weights
    replicated over dp, each dp row decoding its slice of the batch).
    ``quantized`` matches int8 cache leaves ({"q", "s"}: the (B, KV, T)
    scales split on the same batch and head axes)."""
    spec = P(dp_axis, tp_axis, None, None)
    leaf = {"q": spec, "s": P(dp_axis, tp_axis, None)} if quantized else spec
    return {
        "k": [leaf for _ in range(config.n_layers)],
        "v": [leaf for _ in range(config.n_layers)],
    }


def _compatible_spec(shape, spec: P, mesh: Mesh) -> P:
    """Drop the split of dims the axis size does not divide (e.g. an odd
    vocab under tp): those dims stay whole on every rank."""
    fixed = []
    for i, axis in enumerate(spec):
        if axis is None:
            fixed.append(None)
            continue
        size = mesh.shape[axis] if isinstance(axis, str) else 1
        fixed.append(axis if (i < len(shape) and shape[i] % size == 0) else None)
    return P(*fixed)


def local_slice(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` made compatible with its
    shape (a view)."""
    return local_block(x, _compatible_spec(x.shape, spec, mesh), mesh)


def shard_params(params, specs, mesh: Mesh):
    """This rank's blocks of every tensor of ``params`` under the matching
    ``specs`` (each made compatible with its tensor's shape), as tensors
    of their own: the whole tree can be freed after. Dicts and lists are
    walked together; the int8 x int8 marker ``()`` passes through."""
    if isinstance(specs, P):
        return local_slice(params, specs, mesh).clone()
    if isinstance(specs, dict):
        return {k: shard_params(v, specs.get(k, ()), mesh) for k, v in params.items()}
    if isinstance(specs, list):
        if len(specs) != len(params):
            raise ValueError(f"spec tree has {len(specs)} entries, the tree {len(params)}")
        return [shard_params(p, s, mesh) for p, s in zip(params, specs)]
    return params  # the structural marker ``()``


def check_tp_heads(config: LlamaConfig, tp: int) -> None:
    """tp must divide n_heads and n_kv_heads: each rank attends whole
    heads (fairscale asserts the same; the JAX package instead lets XLA
    reshard)."""
    if config.n_heads % tp or config.kv_heads % tp:
        raise ValueError(f"tensor parallelism over {tp} ranks needs n_heads "
                         f"({config.n_heads}) and n_kv_heads ({config.kv_heads}) divisible "
                         f"by {tp}")


def llama_tp_config(config: LlamaConfig, mesh: Mesh, tp_axis: str = "tp") -> LlamaConfig:
    """``config`` for a rank that serves its ``shard_params`` blocks of the
    unfused tree over ``mesh``'s ``tp_axis``: ``forward``, ``init_cache``,
    ``Llama``, the cb server and speculative decoding then run on the
    rank's heads and slices with the collectives over that group. Raises
    where tp does not divide the heads, and for DeepSeek-V2's config."""
    refuse_latent(config, "tensor-parallel serving (tp)")
    check_tp_heads(config, mesh.shape[tp_axis])
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(LlamaConfig)}
    return TensorParallelConfig(**{**fields, "tp_serving": True}, tp_group=mesh.group(tp_axis))
