"""Token sampling (port of prego_tpu/ops/sampling.py:16-72).

Parity surface: sample_top_p (llama/generation.py:398-421): sort
descending, keep the smallest prefix whose cumulative mass exceeds top_p
(mask where cumsum - p_i > p, the exclusive-prefix rule), renormalise over
the kept set, sample, map back through the sort indices. Greedy argmax at
temperature 0.

The draw is Gumbel-max over the log of the kept probabilities, with the
Gumbel noise made from uniforms in [tiny, 1): the construction
``jax.random.categorical`` uses. Callers pass a ``torch.Generator``; tests
pass the uniforms themselves, so both packages can be fed the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch

_TINY = torch.finfo(torch.float32).tiny


def sample_top_p(
    probs: torch.Tensor,  # (B, V) f32 probabilities
    p: float,
    uniforms: torch.Tensor,  # (B, V) f32 in [tiny, 1)
) -> torch.Tensor:
    """(B,) int64 sampled ids."""
    probs_sort, probs_idx = torch.sort(probs, dim=-1, descending=True)
    cumsum = torch.cumsum(probs_sort, dim=-1)
    mask = cumsum - probs_sort > p
    probs_sort = torch.where(mask, torch.zeros_like(probs_sort), probs_sort)
    probs_sort = probs_sort / probs_sort.sum(dim=-1, keepdim=True)
    gumbel = -torch.log(-torch.log(uniforms))
    sampled = torch.argmax(torch.log(probs_sort) + gumbel, dim=-1)
    return torch.gather(probs_idx, -1, sampled[:, None])[:, 0]


def processed_probs(
    logits: torch.Tensor,  # (B, V) f32
    temperature: float,
    top_p: float,
) -> torch.Tensor:
    """The exact distribution ``sample_next_token`` draws from at
    temperature > 0 (prego_tpu/ops/sampling.py:28): softmax at the
    temperature, the exclusive-prefix nucleus cut of ``sample_top_p``,
    renormalised and scattered back to vocabulary order. Speculative
    decoding's rejection rule preserves the target's distribution only
    when p and q are these vectors. (B, V) f32."""
    probs = torch.softmax(logits / max(temperature, 1e-9), dim=-1)
    probs_sort, probs_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cumsum = torch.cumsum(probs_sort, dim=-1)
    probs_sort = torch.where(cumsum - probs_sort > top_p, torch.zeros_like(probs_sort),
                             probs_sort)
    probs_sort = probs_sort / probs_sort.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, probs_idx, probs_sort)


def categorical(probs: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row from (..., V) probabilities: Gumbel-max over their
    log, as ``sample_top_p`` draws (the construction of
    ``jax.random.categorical``). (...,) int64."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=_TINY)))
    return torch.argmax(torch.log(probs) + gumbel, dim=-1)


def sample_next_token(
    logits: torch.Tensor,  # (B, V) f32
    temperature: float,
    top_p: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """temperature > 0: nucleus sampling; == 0: greedy. (B,) int64."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    u = torch.rand(probs.shape, generator=generator, device=probs.device, dtype=torch.float32)
    return sample_top_p(probs, top_p, torch.clamp(u, min=_TINY))
