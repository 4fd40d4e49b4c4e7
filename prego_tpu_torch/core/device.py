"""The device an entry point runs on.

The port runs on the card unless the caller asks for the CPU: the default
is ``cuda``, and asking for ``cuda`` where PyTorch sees no card raises
instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no card is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is false: "
            "the port runs on the card by default; pass --device cpu "
            "(device='cpu') to run on the CPU"
        )
    return dev
