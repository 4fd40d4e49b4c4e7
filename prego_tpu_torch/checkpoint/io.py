"""Recognition checkpoint save/load in the JAX package's format.

The format is ``prego_tpu/checkpoint/io.py``'s: a pickle of a dict
``{"params", "opt_state", "epoch", "rng", "extra"}`` whose arrays are
host numpy. The port writes the same payload (torch tensors become numpy
float arrays on the way out) and reads it without jax.

A checkpoint written by the JAX trainer pickles its optimizer state with
optax's classes. Loading therefore goes through an unpickler that admits
numpy and a short list of builtins and replaces every other class with an
inert stub, so ``params`` loads anywhere and nothing else is imported or
run.
"""

from __future__ import annotations

import builtins
import collections
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

_SAFE_BUILTINS = frozenset(
    {
        "dict", "list", "tuple", "set", "frozenset", "int", "float",
        "complex", "bool", "str", "bytes", "bytearray", "slice", "range",
    }
)


class _Stub:
    """Stand-in for a class the loader does not admit: keeps its
    constructor arguments and state, runs no code of the original."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"<stub {self.qualified_name}>"


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return getattr(builtins, name)
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        return type(name, (_Stub,), {"qualified_name": f"{module}.{name}"})


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return np.asarray(tree) if tree is not None else None


def save_checkpoint(
    path: str,
    params,
    opt_state=None,
    epoch: int = 0,
    rng=None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "params": _to_host(params),
        "opt_state": _to_host(opt_state) if opt_state is not None else None,
        "epoch": epoch,
        "rng": np.asarray(rng) if rng is not None else None,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic: a crash mid-save never corrupts the ckpt


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def load_params(path: str):
    """The checkpoint's parameter pytree, as host numpy arrays."""
    return load_checkpoint(path)["params"]
