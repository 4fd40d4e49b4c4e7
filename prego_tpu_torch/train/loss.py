"""Training criterions (port of prego_tpu/train/loss.py).

Parity surface: OadLoss 'NONUNIFORM' (step_recognition/criterions/loss.py:6-37):
cross-entropy on the LAST frame of each window only, with the one-hot target
L2-normalized (torch F.normalize default: p=2, eps=1e-12) against
log-softmax logits, mean-reduced over the batch.

The model returns last-frame logits (B, K); padding rows of a partial
batch are masked out of the mean by ``valid``. The ANTICIPATION criterion
waits for the ANTICIPATION task (ROADMAP M9).
"""

from __future__ import annotations

from typing import Optional

import torch

from prego_tpu_torch.core.registry import CRITERIONS


def l2_normalize(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    return t / torch.clamp(norm, min=eps)


@CRITERIONS.register("NONUNIFORM")
def last_frame_mlce(
    logits: torch.Tensor, target_last: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """logits: (B, K) last-frame logits; target_last: (B, K); valid: (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    per_example = torch.sum(-l2_normalize(target_last) * logp, dim=-1)  # (B,)
    if valid is None:
        return per_example.mean()
    return torch.sum(per_example * valid) / torch.clamp(torch.sum(valid), min=1.0)
