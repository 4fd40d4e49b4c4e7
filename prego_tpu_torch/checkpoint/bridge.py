"""Parameter bridge between the JAX package and the port.

Both packages keep parameters as nested dicts and lists with the same
keys and the same (in, out) right-multiplication layout, so the bridge is
a structure-checked map between numpy leaves (what the JAX package's
pytrees hold once on the host) and torch tensors on a chosen device.

Covered trees:
  * MiniROAD (``prego_tpu/models/miniroad.py:69-84``): embed, ln, cls, gru;
  * LLaMA (``prego_tpu/models/llama/model.py:41-78``) unfused
    (wq/wk/wv/wo, w1/w2/w3) and after ``fuse_projections``
    (wqkv/wo, w13/w2).

bf16 leaves cross bit-exactly: numpy's ml_dtypes bfloat16 is viewed as
uint16 and reinterpreted on the torch side.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_MINIROAD_KEYS = {"embed", "ln", "cls", "gru"}
_GRU_KEYS = {"w_ih", "b_ih", "w_hh", "b_hh"}
_LLAMA_KEYS = {"tok_embeddings", "layers", "norm", "output"}
_ATTN_KEYS = ({"wq", "wk", "wv", "wo"}, {"wqkv", "wo"})
_FFN_KEYS = ({"w1", "w2", "w3"}, {"w13", "w2"})


def to_tensor(x, device="cpu", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.array(x)  # a private, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # installed with jax; needed only to hand bf16 back

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _check_keys(node: Dict[str, Any], allowed, where: str):
    keys = set(node)
    options = allowed if isinstance(allowed, tuple) else (allowed,)
    if keys not in options:
        raise ValueError(f"{where}: keys {sorted(keys)} match none of {options}")


def check_miniroad_tree(params: Dict[str, Any]) -> None:
    _check_keys(params, _MINIROAD_KEYS, "miniroad")
    _check_keys(params["embed"], {"w", "b"}, "miniroad.embed")
    _check_keys(params["ln"], {"scale", "bias"}, "miniroad.ln")
    _check_keys(params["cls"], {"w", "b"}, "miniroad.cls")
    for i, layer in enumerate(params["gru"]):
        _check_keys(layer, _GRU_KEYS, f"miniroad.gru[{i}]")


def check_llama_tree(params: Dict[str, Any]) -> None:
    _check_keys(params, _LLAMA_KEYS, "llama")
    for i, layer in enumerate(params["layers"]):
        _check_keys(
            layer, {"attention", "feed_forward", "attention_norm", "ffn_norm"},
            f"llama.layers[{i}]",
        )
        _check_keys(layer["attention"], _ATTN_KEYS, f"llama.layers[{i}].attention")
        _check_keys(layer["feed_forward"], _FFN_KEYS, f"llama.layers[{i}].feed_forward")


def miniroad_from_numpy(params, device="cpu", dtype: Optional[torch.dtype] = None):
    """JAX MiniROAD pytree (numpy leaves) -> the port's tensor dict."""
    check_miniroad_tree(params)
    return _map(params, lambda a: to_tensor(a, device, dtype))


def llama_from_numpy(params, device="cpu", dtype: Optional[torch.dtype] = None):
    """JAX LLaMA pytree, unfused or fused (numpy leaves) -> tensor dict."""
    check_llama_tree(params)
    return _map(params, lambda a: to_tensor(a, device, dtype))


def to_numpy_tree(params):
    """The port's tensor dict -> numpy pytree the JAX package accepts."""
    return _map(params, to_numpy)
