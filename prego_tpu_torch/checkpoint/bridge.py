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

Optimizer state crosses too. optax's Adam and AdamW state flattens
(``jax.tree.leaves``) to count, the ``mu`` tree, the ``nu`` tree, and a
second count where a learning-rate schedule is on. ``adam_to_optax``
writes the port's torch Adam/AdamW state as a list with those leaves in
that order, so ``prego_tpu.cli.train --resume`` unflattens it into its
own optax state unchanged; ``adam_from_optax`` reads either that list or
a JAX checkpoint's stubbed optax state back into ``step``, ``exp_avg``
and ``exp_avg_sq``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from prego_tpu_torch.checkpoint.io import tree_leaves

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


def _adam_moment(optimizer: torch.optim.Optimizer, p: torch.Tensor, key: str) -> np.ndarray:
    state = optimizer.state.get(p)
    return to_numpy(state[key]) if state else np.zeros(tuple(p.shape), np.float32)


def adam_to_optax(optimizer: torch.optim.Optimizer, params, schedule: bool) -> List[Any]:
    """[count, mu, nu] (+ [count] with a schedule): ``jax.tree.leaves`` of
    it are optax's Adam/AdamW state leaves, in optax's order; mu and nu
    keep the parameters' tree."""
    first = optimizer.state.get(tree_leaves(params)[0])
    count = np.asarray(int(first["step"]) if first else 0, np.int32)
    mu = _map(params, lambda p: _adam_moment(optimizer, p, "exp_avg"))
    nu = _map(params, lambda p: _adam_moment(optimizer, p, "exp_avg_sq"))
    return [count, mu, nu] + ([count.copy()] if schedule else [])


def adam_from_optax(optimizer: torch.optim.Optimizer, params, opt_state) -> int:
    """Load optax-ordered Adam/AdamW state (the port's list, or a JAX
    checkpoint's stubbed optax tuple) into ``optimizer``'s state for the
    tensors of ``params``. Returns the update count."""
    plist = tree_leaves(params)
    leaves = tree_leaves(opt_state)
    N = len(plist)
    if len(leaves) not in (2 * N + 1, 2 * N + 2):
        raise ValueError(
            f"optimizer state has {len(leaves)} leaves; Adam over {N} parameters "
            f"has {2 * N + 1} (or {2 * N + 2} with a schedule)"
        )
    count = int(np.asarray(leaves[0]))
    for p, m, v in zip(plist, leaves[1 : 1 + N], leaves[1 + N : 1 + 2 * N]):
        if tuple(np.shape(m)) != tuple(p.shape) or tuple(np.shape(v)) != tuple(p.shape):
            raise ValueError(f"optimizer moment of shape {np.shape(m)} for a parameter {tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": to_tensor(m, p.device, p.dtype),
            "exp_avg_sq": to_tensor(v, p.device, p.dtype),
        }
    return count
