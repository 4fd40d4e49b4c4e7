"""Seeding utilities.

The reference seeds python/numpy/torch globally (step_recognition/utils/
util.py:26-34). Here host RNGs (python, numpy) are seeded globally, and
every torch draw goes through an explicit ``torch.Generator`` that the
caller creates and passes, so no global torch RNG state is shared.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed the host RNGs (python, numpy)."""
    random.seed(seed)
    np.random.seed(seed)


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """A seeded generator on ``device`` (a CUDA generator draws on the card)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
