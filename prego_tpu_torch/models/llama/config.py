"""LLaMA model hyperparameters.

Parity surface: ModelArgs (step_anticipation/llama/model.py:19-31) plus the
params.json loader (generation.py:107-117). rope_theta is exposed for
LLaMA-3-family checkpoints.

``DeepseekV2Config`` adds the block of DeepSeek-V2 (arXiv:2405.04434):
multi-head latent attention (``mla.py``) and DeepSeekMoE (``moe.py``),
which the port serves through the same ``forward`` and ``Llama``. It has
no counterpart in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os.path as osp
import math
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


def _yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention factor (DeepSeek-V2's ``yarn_get_mscale``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


@dataclass(frozen=True)
class DeepseekV2Config(LlamaConfig):
    """DeepSeek-V2's block (HF ``DeepseekV2ForCausalLM``, config.json keys in
    the comments): multi-head latent attention without a query LoRA, YaRN
    rotary on the ``qk_rope_head_dim`` part, and DeepSeekMoE in every layer
    from ``first_k_dense_replace`` on; the layers before it are a dense
    SwiGLU of ``intermediate_size``. ``n_kv_heads`` is not read: the cache
    holds one latent a position (``mla.py``). The routed weights are the
    top-k scores as they are (``norm_topk_prob`` false,
    ``routed_scaling_factor`` 1, as in every DeepSeek-V2 config)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944  # the dense layers' SwiGLU width
    moe_intermediate_size: int = 1408  # one routed expert's width
    n_routed_experts: int = 64
    n_shared_experts: int = 2  # one SwiGLU of n_shared_experts * moe_intermediate_size
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    # rope_scaling {"type": "yarn", ...}
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707

    @property
    def ffn_hidden(self) -> int:
        return self.intermediate_size

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """q_head_dim^-0.5 times YaRN's factor squared (DeepseekV2Attention)."""
        m = (_yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
             if self.rope_mscale_all_dim else 1.0)
        return self.q_head_dim ** -0.5 * m * m

    @property
    def rope_cos_scale(self) -> float:
        """The factor on the YaRN cos and sin tables: mscale over mscale_all_dim."""
        return (_yarn_mscale(self.rope_factor, self.rope_mscale)
                / _yarn_mscale(self.rope_factor, self.rope_mscale_all_dim))

    @property
    def shared_hidden(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size

    def is_moe_layer(self, i: int) -> bool:
        return i >= self.first_k_dense_replace and i % self.moe_layer_freq == 0

    @property
    def n_moe_layers(self) -> int:
        return sum(self.is_moe_layer(i) for i in range(self.n_layers))


def is_latent(config: LlamaConfig) -> bool:
    """Whether ``config`` is DeepSeek-V2's block (MLA and MoE)."""
    return isinstance(config, DeepseekV2Config)


def refuse_latent(config: LlamaConfig, what: str) -> None:
    """Raise for a path that serves only the LLaMA block."""
    if is_latent(config):
        raise ValueError(f"{what} does not take the MLA/MoE configuration (DeepseekV2Config): "
                         "it serves the LLaMA block only; serve DeepSeek-V2 through "
                         "Llama / TorchLlamaLLM(serving='batch') in bf16")


def deepseek_v2_lite_config(max_seq_len: int = 1024, max_batch_size: int = 32,
                            vocab_size: int = 102400) -> DeepseekV2Config:
    """DeepSeek-V2-Lite at its published widths and depth
    (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json)."""
    return DeepseekV2Config(dim=2048, n_layers=27, n_heads=16, n_kv_heads=16,
                            vocab_size=vocab_size, norm_eps=1e-6, rope_theta=10000.0,
                            max_batch_size=max_batch_size, max_seq_len=max_seq_len)


def tiny_deepseek_v2_config(vocab_size: int = 258, max_seq_len: int = 128,
                            max_batch_size: int = 4) -> DeepseekV2Config:
    """A miniature DeepSeek-V2 for CPU tests: 3 layers (one dense), 4 heads,
    16 experts of which 4 a token, 1 shared."""
    return DeepseekV2Config(
        dim=64, n_layers=3, n_heads=4, n_kv_heads=4, vocab_size=vocab_size, norm_eps=1e-6,
        max_batch_size=max_batch_size, max_seq_len=max_seq_len, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, intermediate_size=96,
        moe_intermediate_size=32, n_routed_experts=16, n_shared_experts=1,
        num_experts_per_tok=4, rope_original_max_position=64)
