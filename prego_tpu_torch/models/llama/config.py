"""LLaMA model hyperparameters.

Parity surface: ModelArgs (step_anticipation/llama/model.py:19-31) plus the
params.json loader (generation.py:107-117). rope_theta is exposed for
LLaMA-3-family checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os.path as osp
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)  # hashable: usable as a dict key
class LlamaConfig:
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: Optional[int] = None
    vocab_size: int = -1  # set from the tokenizer
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    # Multi-chip serving marker: params/cache are sharded over a ('tp',)
    # mesh axis. The Pallas decode kernels lower to custom calls XLA's
    # SPMD partitioner cannot split, so with tp_serving=True every kernel
    # gate (flash/bounded decode attention, fused dense/FFN) stays off
    # and the equivalent jnp paths run — those partition cleanly with
    # collectives over ICI (SURVEY.md §2.4). Single-chip serving keeps
    # the kernels. In the port it marks a rank that serves its shards of
    # the unfused tree (parallel/sharding.py::llama_tp_config): the fused
    # kernels stay off, the kernels that compute the same function on a
    # shard (K2, K3, K4, K5) stay on.
    tp_serving: bool = False

    @property
    def tp_size(self) -> int:
        """Ranks the heads, the FFN and the vocabulary are split over (1 but
        for a ``TensorParallelConfig``)."""
        group = getattr(self, "tp_group", None)
        if group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(group)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_hidden(self) -> int:
        # SwiGLU sizing (model.py:332-337)
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)

    @classmethod
    def from_params_json(cls, ckpt_dir: str, **overrides) -> "LlamaConfig":
        with open(osp.join(ckpt_dir, "params.json")) as f:
            params = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        params = {k: v for k, v in params.items() if k in known}
        params.update(overrides)
        return cls(**params)


@dataclass(frozen=True)
class TensorParallelConfig(LlamaConfig):
    """The config of a rank that serves its blocks of the tree under tensor
    parallelism (``parallel/sharding.py::llama_tp_config``): ``tp_group``
    is its process group (torch.distributed), which is not part of the
    config's identity. ``dataclasses.replace`` keeps it."""

    tp_group: Any = field(default=None, compare=False, repr=False)


def tiny_test_config(vocab_size: int = 256) -> LlamaConfig:
    """A miniature config for CPU tests."""
    return LlamaConfig(
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        vocab_size=vocab_size,
        multiple_of=16,
        norm_eps=1e-5,
        max_batch_size=4,
        max_seq_len=128,
    )
