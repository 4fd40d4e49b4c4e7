"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The parity tests feed the same numpy inputs, made from a seed, to a JAX
function (on the CPU, as tests/conftest.py sets it up) and to its
counterpart in prego_tpu_torch, and compare in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or a jax array) -> CPU torch tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch tensor or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)
