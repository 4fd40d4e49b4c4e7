"""Checkpoint converters: Meta and Hugging Face LLaMA weights -> the port's
parameter tree (port of prego_tpu/checkpoint/convert.py).

Meta's reference loads one ``consolidated.XX.pth`` per fairscale
model-parallel rank (llama/generation.py:101-120). Here all shards merge
into one tree: column-parallel weights concatenated along torch dim 0,
row-parallel ones along dim 1, the fairscale ParallelEmbedding along the
embedding dim (1); norms are replicated. Dense weights are transposed to
the (in, out) right-multiplication layout of ``models/llama/model.py``
(the layout ``checkpoint/bridge.py`` carries). The result equals the JAX
converter's bit for bit: a leaf is cast to ``dtype`` straight from the
file's dtype where that dtype is ``dtype``, else through f32, as the JAX
converter casts every leaf (bf16 -> f32 -> bf16 is exact).

HF's exporter permutes the q and k projection rows for its non-interleaved
rotary convention; ``_inverse_hf_permute`` restores Meta's order for the
port's paired rotation. HF weights come from ``pytorch_model*.bin`` or
``*.safetensors``; the latter are read here (``load_safetensors``: an
8-byte header length, a JSON header, raw little-endian data), so the port
needs no safetensors package.

``device`` is where the tree is built: each merged tensor moves there
before its transpose and cast.
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from prego_tpu_torch.models.llama.config import LlamaConfig

COLUMN_PARALLEL = ("wq", "wk", "wv", "w1", "w3", "output")  # split along torch dim 0
ROW_PARALLEL = ("wo", "w2")  # split along torch dim 1

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def _cast(t: torch.Tensor, dtype, device) -> torch.Tensor:
    t = t.to(device)
    if t.dtype != dtype:
        t = t.to(torch.float32).to(dtype)
    return t.contiguous()


def _dense(t: torch.Tensor, dtype, device) -> torch.Tensor:
    """A torch Linear weight (out, in) as the port's (in, out) leaf."""
    return _cast(t.to(device).t(), dtype, device)


def _tree(get, config: LlamaConfig, names: Dict[str, str]) -> Dict[str, Any]:
    """The unfused parameter tree from ``get(key, kind)``, kind "dense"
    (transposed), "dense_q"/"dense_k" (transposed after HF's inverse
    permute) or "vector"; ``names`` maps the tree's leaf names to the
    checkpoint's key patterns."""
    layers = []
    for i in range(config.n_layers):
        key = lambda leaf: names[leaf].format(i=i)
        layers.append({
            "attention": {
                "wq": get(key("wq"), "dense_q"),
                "wk": get(key("wk"), "dense_k"),
                "wv": get(key("wv"), "dense"),
                "wo": get(key("wo"), "dense"),
            },
            "feed_forward": {w: get(key(w), "dense") for w in ("w1", "w2", "w3")},
            "attention_norm": get(key("attention_norm"), "vector"),
            "ffn_norm": get(key("ffn_norm"), "vector"),
        })
    return {
        "tok_embeddings": get(names["tok_embeddings"], "vector"),
        "norm": get(names["norm"], "vector"),
        "output": get(names["output"], "dense"),
        "layers": layers,
    }


_META_NAMES = {
    "tok_embeddings": "tok_embeddings.weight", "norm": "norm.weight",
    "output": "output.weight",
    **{w: f"layers.{{i}}.attention.{w}.weight" for w in ("wq", "wk", "wv", "wo")},
    **{w: f"layers.{{i}}.feed_forward.{w}.weight" for w in ("w1", "w2", "w3")},
    "attention_norm": "layers.{i}.attention_norm.weight",
    "ffn_norm": "layers.{i}.ffn_norm.weight",
}


def convert_meta_checkpoint(
    ckpt_dir: str, config: LlamaConfig, dtype=torch.bfloat16, device="cpu"
) -> Dict[str, Any]:
    """Merge Meta ``consolidated.*.pth`` shards into the port's tree."""
    paths = sorted(Path(ckpt_dir).glob("*.pth"))
    if not paths:
        raise FileNotFoundError(f"no checkpoint files found in {ckpt_dir}")
    shards = [torch.load(p, map_location="cpu", weights_only=True, mmap=True) for p in paths]

    def merged(key: str) -> torch.Tensor:
        tensors = [s[key] for s in shards]
        leaf = key.rsplit(".", 2)[-2] if "." in key else key
        if len(tensors) == 1:
            return tensors[0]
        if key == "tok_embeddings.weight":
            return torch.cat(tensors, dim=1)  # fairscale ParallelEmbedding: the embedding dim
        if leaf in COLUMN_PARALLEL:
            return torch.cat(tensors, dim=0)
        if leaf in ROW_PARALLEL:
            return torch.cat(tensors, dim=1)
        return tensors[0]  # replicated (norm weights)

    def get(key, kind):
        w = merged(key)
        return _cast(w, dtype, device) if kind == "vector" else _dense(w, dtype, device)

    params = _tree(get, config, _META_NAMES)
    del shards
    return params


def _inverse_hf_permute(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Undo HF's rotary permutation of q / k rows; w: torch layout (out, in)."""
    out_dim, in_dim = w.shape
    return (w.reshape(n_heads, 2, out_dim // n_heads // 2, in_dim).transpose(1, 2)
            .reshape(out_dim, in_dim))


_HF_NAMES = {
    "tok_embeddings": "model.embed_tokens.weight", "norm": "model.norm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "w1": "model.layers.{i}.mlp.gate_proj.weight",
    "w2": "model.layers.{i}.mlp.down_proj.weight",
    "w3": "model.layers.{i}.mlp.up_proj.weight",
    "attention_norm": "model.layers.{i}.input_layernorm.weight",
    "ffn_norm": "model.layers.{i}.post_attention_layernorm.weight",
}


def convert_hf_checkpoint(
    model_dir: str, config: LlamaConfig, dtype=torch.bfloat16, device="cpu"
) -> Dict[str, Any]:
    """Convert a Hugging Face LLaMA export (safetensors or .bin)."""
    state = _load_hf_state_dict(model_dir)
    heads = {"dense_q": config.n_heads, "dense_k": config.kv_heads}

    def get(key, kind):
        w = state[key]
        if kind == "vector":
            return _cast(w, dtype, device)
        if kind in heads:
            w = _inverse_hf_permute(w, heads[kind])
        return _dense(w, dtype, device)

    # tied embeddings: an export without lm_head.weight reuses the embedding
    names = {**_HF_NAMES, "output": "lm_head.weight" if "lm_head.weight" in state
             else "model.embed_tokens.weight"}
    return _tree(get, config, names)


def safetensors_header(path: str) -> Tuple[int, Dict[str, Any]]:
    """(the offset where a ``.safetensors`` file's data starts, its header
    without ``__metadata__``): an 8-byte little-endian header length, that
    many bytes of JSON (name -> dtype, shape, [begin, end) data offsets),
    then the little-endian data the offsets index."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}")
    return 8 + n, header


def load_safetensors(path: str, device="cpu", select=None) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file on ``device``: the file is
    mapped, and each tensor copied from the map straight into a tensor of
    its stored dtype there. ``select(name, view)``, where given, picks the
    part of each mapped tensor to copy (a rank's block of it)."""
    start, header = safetensors_header(path)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) as buf:
        for name, info in header.items():
            dtype = _ST_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape: List[int] = info["shape"]
            count = (end - begin) // dtype.itemsize
            if not count:
                out[name] = torch.empty(shape, dtype=dtype, device=device)
                continue
            view = torch.frombuffer(buf, dtype=dtype, count=count, offset=start + begin)
            part = view.reshape(shape) if select is None else select(name, view.reshape(shape))
            # copied out before the map closes
            out[name] = part.to(device, copy=True).contiguous()
            del view, part
    return out


def _load_hf_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    st_files = sorted(Path(model_dir).glob("*.safetensors"))
    state: Dict[str, torch.Tensor] = {}
    if st_files:
        for p in st_files:
            state.update(load_safetensors(str(p)))
        return state
    for p in sorted(Path(model_dir).glob("pytorch_model*.bin")):
        state.update(torch.load(p, map_location="cpu", weights_only=True))
    if not state:
        raise FileNotFoundError(f"no HF weights found in {model_dir}")
    return state
