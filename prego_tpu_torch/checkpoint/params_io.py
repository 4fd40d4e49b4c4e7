"""Save and restore LLaMA parameter trees directly (the port's counterpart
of prego_tpu/checkpoint/orbax_io.py; Orbax is JAX-only).

The reference loads Meta's consolidated .pth shards on every launch
(llama/generation.py:101-120). Here a converted tree, or the int8 serving
tree, is written once and later launches restore it straight onto the
device:

    save_llama_params(dir, params, config)
    params = load_llama_params(dir, config, device="cuda", quantized=True)

Format: ``dir/params.safetensors`` holds every tensor under its path in
the tree (``layers.0.attention.wqkv.q``; an int8 projection is ``q`` int8
and ``s`` f32, the int8 x int8 marker ``"act"`` holds no tensor), and
``dir/manifest.json`` the layout (``quantized``, ``fused``,
``activations``) and the config. The manifest is written last, so a
directory whose write was cut short has none and is refused. Tensors are
laid out f32 first, then bf16, then int8, so each starts at a multiple of
its element size; the file is a standard safetensors file.

Restore reads the file through ``mmap`` (``convert.load_safetensors``,
the port's own reader) and copies each tensor from there into a device
tensor of its stored dtype; a float leaf is then cast to ``dtype`` if
that differs. An int8 restore allocates each int8 and scale
tensor once on the device and never makes a bf16 copy of a weight, on
the host or the device (what ``orbax_io.load_llama_params(quantized=True)``
is for: a 7B int8 tree restores in its ~6.7 GB). A directory that Orbax
wrote is refused with a message, not misread. With a ``mesh`` (a bf16 /
f32 tree), each rank copies only its blocks of every tensor under
``llama_param_specs`` from the map (the JAX function's sharded restore,
without the whole tree on any device); an int8 tree is the one-card
serving layout and is not restored onto a mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import struct
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch

from prego_tpu_torch.checkpoint.convert import _ST_DTYPES, load_safetensors, safetensors_header
from prego_tpu_torch.core.device import resolve_device
from prego_tpu_torch.models.llama.config import LlamaConfig

WEIGHTS = "params.safetensors"
MANIFEST = "manifest.json"
FORMAT = "prego_tpu_torch.llama_params"
# what Orbax's StandardCheckpointer leaves in a checkpoint directory
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding")

_DTYPE_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def flat_tensors(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A parameter tree as path -> tensor (``layers.0.attention.wqkv.q``);
    the empty-tuple marker ``"act"`` holds no tensor."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tensors(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tensors(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def flat_specs(specs, prefix: str = "") -> Dict[str, Any]:
    """A PartitionSpec tree as path -> spec, in ``flat_tensors``' paths."""
    from prego_tpu_torch.parallel.mesh import PartitionSpec

    if isinstance(specs, PartitionSpec):
        return {prefix[:-1]: specs}
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flat_specs(v, f"{prefix}{k}."))
    return out


def _layout(params) -> Dict[str, bool]:
    """(quantized, fused, activations) of a LLaMA tree, read off its lm-head
    and first layer."""
    from prego_tpu_torch.models.llama.model import is_quantized

    attn = params["layers"][0]["attention"] if params["layers"] else {}
    out = params["output"]
    return {"quantized": is_quantized(out), "fused": "wqkv" in attn,
            "activations": is_quantized(out) and "act" in out}


def _expected_shapes(config: LlamaConfig, quantized: bool, fused: bool
                     ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Path -> (shape, kind) of the tree ``config`` gives in this layout,
    kind "float", "int8" or "scale" (the JAX function's skeleton, without
    building one)."""
    D, V, F = config.dim, config.vocab_size, config.ffn_hidden
    H, KV, hd = config.n_heads, config.kv_heads, config.head_dim
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def dense(path, k, n):
        if quantized:
            out[f"{path}.q"] = ((k, n), "int8")
            out[f"{path}.s"] = ((1, n), "scale")
        else:
            out[path] = ((k, n), "float")

    out["tok_embeddings"] = ((V, D), "float")
    out["norm"] = ((D,), "float")
    dense("output", D, V)
    for i in range(config.n_layers):
        a, f = f"layers.{i}.attention", f"layers.{i}.feed_forward"
        if fused:
            dense(f"{a}.wqkv", D, (H + 2 * KV) * hd)
            dense(f"{f}.w13", D, 2 * F)
        else:
            dense(f"{a}.wq", D, H * hd)
            dense(f"{a}.wk", D, KV * hd)
            dense(f"{a}.wv", D, KV * hd)
            dense(f"{f}.w1", D, F)
            dense(f"{f}.w3", D, F)
        dense(f"{a}.wo", H * hd, D)
        dense(f"{f}.w2", F, D)
        out[f"layers.{i}.attention_norm"] = ((D,), "float")
        out[f"layers.{i}.ffn_norm"] = ((D,), "float")
    return out


def save_llama_params(path: str, params: Dict[str, Any],
                      config: Optional[LlamaConfig] = None) -> None:
    """Write ``params`` (on any device) under the directory ``path``,
    replacing what the port wrote there before; ``config``, where given,
    goes into the manifest and is checked on restore."""
    flat = flat_tensors(params)
    for name, t in flat.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be saved")
    # f32, then 2-byte, then int8 tensors: every offset a multiple of its
    # element size once the header is padded to 8 bytes
    order = sorted(flat, key=lambda k: -flat[k].element_size())
    header: Dict[str, Any] = {"__metadata__": {"format": FORMAT}}
    offset = 0
    for name in order:
        t = flat[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    os.makedirs(path, exist_ok=True)
    manifest_path = osp.join(path, MANIFEST)
    if osp.exists(manifest_path):
        os.remove(manifest_path)  # the directory holds no valid tree until the end
    tmp = osp.join(path, WEIGHTS + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = flat[name].detach().contiguous().reshape(-1)
            f.write(memoryview(t.view(torch.uint8).cpu().numpy()))
    os.replace(tmp, osp.join(path, WEIGHTS))
    manifest = {"format": FORMAT, **_layout(params),
                "config": ({f.name: getattr(config, f.name)
                            for f in dataclasses.fields(LlamaConfig)}
                           if config is not None else None),
                "tensors": len(flat), "bytes": offset}
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1)


def read_manifest(path: str) -> Dict[str, Any]:
    """The manifest of a directory ``save_llama_params`` wrote; raises for
    a directory Orbax wrote, and for one that holds neither."""
    manifest_path = osp.join(path, MANIFEST)
    if not osp.exists(manifest_path):
        if any(osp.exists(osp.join(path, n)) for n in _ORBAX_FILES):
            raise ValueError(
                f"{path} holds an Orbax checkpoint (written by the JAX package's "
                "prego_tpu.checkpoint.orbax_io); the PyTorch port cannot read Orbax's "
                "format. Point --orbax_dir at a new directory: the port converts the "
                "checkpoint once and writes its own cache there.")
        raise FileNotFoundError(f"{path} holds no {MANIFEST} of saved LLaMA parameters")
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{manifest_path}: format {manifest.get('format')!r}, not {FORMAT!r}")
    return manifest


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        node = root
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t

    def lists(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node

    return lists(root)


def load_llama_params(
    path: str,
    config: LlamaConfig,
    device="cuda",
    dtype=torch.bfloat16,
    quantized: bool = False,
    fused: Optional[bool] = None,
    activations: bool = False,
    mesh=None,
) -> Dict[str, Any]:
    """Restore a tree ``save_llama_params`` wrote onto ``device`` (the card
    by default; raises where there is none).

    The layout asked for must be the one stored, else ValueError:
    ``quantized`` (int8 ``{q, s}`` projections), ``fused`` (wqkv, w13;
    default as the JAX function's skeleton: fused for an int8 restore,
    unfused otherwise) and ``activations`` (the int8 x int8 marker). Every
    tensor's shape is checked against ``config``, and so is the stored
    config where there is one; the vocabulary is the stored table's, as
    the converters take a checkpoint's table whatever its tokenizer's size
    (a byte tokenizer over a 32000-row table). Float leaves come out in
    ``dtype``; ``q`` stays int8 and ``s`` f32. With ``mesh``
    (``parallel.make_mesh``), this rank's blocks of the unfused float tree
    under ``llama_param_specs``; ``quantized`` with a mesh raises."""
    if quantized and mesh is not None:
        raise ValueError(
            "quantized restore is the single-card serving layout; restore the bf16 "
            "tree onto the mesh and quantize each rank's blocks instead")
    device = resolve_device(device)
    if fused is None:
        fused = quantized
    manifest = read_manifest(path)
    asked = {"quantized": quantized, "fused": fused,
             "activations": bool(quantized and activations)}
    stored = {k: bool(manifest[k]) for k in asked}
    if stored != asked:
        raise ValueError(f"{path} holds a tree of layout {stored}; asked for {asked}")
    if manifest.get("config") is not None:
        have = LlamaConfig(**manifest["config"])
        fields = ("dim", "n_layers", "n_heads", "kv_heads", "ffn_hidden")
        diff = {f: (getattr(have, f), getattr(config, f)) for f in fields
                if getattr(have, f) != getattr(config, f)}
        if diff:
            raise ValueError(f"{path} was saved for another config: {diff} (stored, asked)")
    weights = osp.join(path, WEIGHTS)
    _, header = safetensors_header(weights)
    table = header.get("tok_embeddings", {}).get("shape", [config.vocab_size])[0]
    want = _expected_shapes(replace(config, vocab_size=table), quantized, fused)
    if set(header) != set(want):
        missing, extra = sorted(set(want) - set(header)), sorted(set(header) - set(want))
        raise ValueError(f"{path}: tensors differ from the config's tree "
                         f"(missing {missing[:4]}, unexpected {extra[:4]})")
    for name, (shape, kind) in want.items():
        info = header[name]
        stored = _ST_DTYPES[info["dtype"]]
        ok = {"int8": stored == torch.int8, "scale": stored == torch.float32,
              "float": stored.is_floating_point}[kind]
        if not ok or tuple(info["shape"]) != shape:
            raise ValueError(f"{path}: {name} is {info['dtype']} {info['shape']}, "
                             f"expected a {kind} tensor of shape {list(shape)}")
    select = None
    if mesh is not None:
        from prego_tpu_torch.parallel.sharding import llama_param_specs, local_slice

        specs = flat_specs(llama_param_specs(config, fused=fused))
        select = lambda name, view: local_slice(view, specs[name], mesh)  # noqa: E731
    out = load_safetensors(weights, device, select)
    for name, (_, kind) in want.items():
        if kind == "float" and out[name].dtype != dtype:
            out[name] = out[name].to(dtype)
    tree = _unflatten(out)
    if quantized and activations:
        from prego_tpu_torch.models.llama.model import mark_activations

        tree = mark_activations(tree, True)
    return tree
