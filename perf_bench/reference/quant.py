"""The lower precisions the controls compute in: products whose operands
are rounded to int8 (one scale a weight column, one a row of
activations), the scheme of the port's int8 x int8 path."""

from __future__ import annotations

import torch


def int8(t: torch.Tensor, kind: str) -> torch.Tensor:
    """``t`` rounded to int8 and back: a weight (in, out) by output column,
    activations (..., in) by row."""
    dim = 0 if kind == "weight" else -1
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.round(t / s).clamp(-127, 127) * s
