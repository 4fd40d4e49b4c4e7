"""LLM seam for step anticipation (port of prego_tpu/anticipation/llm.py).

Every backend answers ``text_completion(prompts, max_gen_len,
temperature, top_p)`` with ``{"generation": str}`` dicts, the prompt echo
stripped (llama/generation.py:233-282). Here:

  * FakeLLM: the deterministic next-symbol oracle for hermetic runs;
  * TorchLlamaLLM (``torch-llama``): the port's LLaMA decoder on one
    device, in the single-card fused layout (wqkv, w13), bf16 on the card.

Loading a Meta or HF checkpoint needs a converter that imports no jax;
until it exists (ROADMAP) TorchLlamaLLM takes random weights at a
reference shape (``fabricated=``) or parameters handed over through
``checkpoint/bridge.py`` (``params=`` with ``config=``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Protocol

import torch

from prego_tpu_torch.core.device import resolve_device
from prego_tpu_torch.core.registry import LLMS


class CompletionLLM(Protocol):
    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]: ...


@LLMS.register("fake")
class FakeLLM:
    """Deterministic in-context next-symbol oracle: answers with a function
    of the history parsed from the prompt (default: its last symbol)."""

    def __init__(self, oracle: Optional[Callable[[List[str]], str]] = None):
        self.oracle = oracle or (lambda hist: hist[-1])
        self.calls: List[List[str]] = []

    def _history_from_prompt(self, prompt: str) -> List[str]:
        # the step prompt ends "...{input}\n {hist}\n{output}\n": the
        # history is the penultimate non-empty line
        lines = [ln for ln in prompt.split("\n") if ln.strip()]
        hist_line = lines[-2] if len(lines) >= 2 else ""
        return [tok.strip() for tok in hist_line.split(",") if tok.strip()]

    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]:
        self.calls.append(list(prompts))
        return [{"generation": f" {self.oracle(self._history_from_prompt(p))}"} for p in prompts]


# reference serving shapes (llama/model.py:20-31 and the 7B/13B checkpoints
# of Llama.build); "1b" and "tiny" are small stand-ins
FABRICATED_SHAPES = {
    "7b": dict(dim=4096, n_layers=32, n_heads=32),
    "13b": dict(dim=5120, n_layers=40, n_heads=40),
    "1b": dict(dim=2048, n_layers=16, n_heads=16),
    "tiny": dict(dim=64, n_layers=2, n_heads=4),
}


def fabricated_config(shape: str, max_seq_len: int, max_batch_size: int, n_layers=None):
    """The LlamaConfig of a fabricated shape (the JAX adapter's
    ``_init_fabricated``); ``n_layers`` cuts depth, widths stay."""
    from prego_tpu_torch.models.llama.config import LlamaConfig

    s = FABRICATED_SHAPES[shape]
    return LlamaConfig(
        dim=s["dim"], n_layers=n_layers or s["n_layers"], n_heads=s["n_heads"],
        n_kv_heads=s["n_heads"], vocab_size=32000 if shape in ("7b", "13b") else 258,
        multiple_of=256 if shape != "tiny" else 16, norm_eps=1e-5,
        max_batch_size=max_batch_size, max_seq_len=max_seq_len,
    )


@LLMS.register("torch-llama")
class TorchLlamaLLM:
    """The port's LLaMA backend (the counterpart of ``jax-llama``)."""

    def __init__(
        self,
        ckpt_dir: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_seq_len: int = 512,
        max_batch_size: int = 8,
        fabricated: Optional[str] = None,  # "7b"/"13b"/"1b"/"tiny": random weights
        params=None,  # the port's parameter dict (checkpoint/bridge.py)
        config=None,  # its LlamaConfig, required with params
        device: str = "cuda",  # raises where there is no card; "cpu" on request
    ):
        from prego_tpu_torch.models.llama import ByteTokenizer, Llama, load_tokenizer
        from prego_tpu_torch.models.llama.model import fuse_projections, init_params

        device = resolve_device(device)
        # bf16 is the serving dtype on the card; the CPU path runs f32, as
        # the JAX package does off the TPU
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        tokenizer = load_tokenizer(tokenizer_path) if tokenizer_path else ByteTokenizer()
        if params is not None:
            if config is None:
                raise ValueError("params= needs config=")
            if "wqkv" not in params["layers"][0]["attention"]:
                params = fuse_projections(params)
        elif fabricated is not None:
            config = fabricated_config(fabricated, max_seq_len, max_batch_size)
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            params = fuse_projections(init_params(config, gen, dtype=dtype, device=device))
        else:
            raise NotImplementedError(
                f"loading {ckpt_dir!r}: converting a Meta/HF checkpoint without jax "
                "is not ported yet (ROADMAP); use fabricated= or params="
            )
        self.llama = Llama(params, tokenizer, config)

    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]:
        return self.llama.text_completion(
            prompts, temperature=temperature, top_p=top_p,
            max_gen_len=max_gen_len, use_prefix_cache=True,  # prompts share long prefixes
        )


def build_llm(name: str, **kwargs) -> CompletionLLM:
    return LLMS.get(name)(**kwargs)
