"""LLM seam for step anticipation (port of prego_tpu/anticipation/llm.py).

Every backend answers ``text_completion(prompts, max_gen_len,
temperature, top_p)`` with ``{"generation": str}`` dicts, the prompt echo
stripped (llama/generation.py:233-282). Here:

  * FakeLLM: the deterministic next-symbol oracle for hermetic runs;
  * TorchLlamaLLM (``torch-llama``): the port's LLaMA decoder on one
    device, in the single-card fused layout (wqkv, w13), bf16 on the card;
    ``quantize="int8"`` serves int8 weights (K4), ``"int8x8"`` int8 weights
    and per-token int8 activations (K5), ``kv_quant`` an int8 KV cache (K3);
    ``serving="cb"`` routes every call through the continuous-batching
    slot loop (``serving_llm.ContinuousBatcher``, ``cb_slots`` slots).

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
        quantize=False,  # False | True/"int8" (weight-only) | "int8x8" (int8 x int8)
        kv_quant: bool = False,  # int8 KV cache
        serving: str = "batch",  # "batch": drain-style generate (reference
        # semantics); "cb": every text_completion through the
        # continuous-batching slot loop (serving_llm.ContinuousBatcher)
        cb_slots: Optional[int] = None,  # cb slot count (default max_batch_size)
    ):
        from prego_tpu_torch.models.llama import ByteTokenizer, Llama, load_tokenizer
        from prego_tpu_torch.models.llama.model import (
            fuse_projections, init_params, init_params_quantized, is_quantized,
            mark_activations, quantize_params,
        )

        if quantize is True:
            quantize = "int8"
        if quantize not in (False, "int8", "int8x8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (False|'int8'|'int8x8')")
        act_quant = quantize == "int8x8"
        if serving not in ("batch", "cb"):
            raise ValueError(f"unknown serving mode {serving!r} (batch|cb)")
        self._serving = serving
        self._cb_slots = cb_slots
        self._cb = None  # built on the first cb call
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
            if is_quantized(params["output"]):
                # an int8 tree runs as given, its marker set by ``quantize``
                if quantize:
                    params = mark_activations(params, act_quant)
            elif quantize:
                params = quantize_params(params, activations=act_quant)
        elif fabricated is not None:
            config = fabricated_config(fabricated, max_seq_len, max_batch_size)
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            if quantize:  # int8 drawn directly: no bf16 model first
                params = init_params_quantized(config, gen, fused=True, dtype=dtype,
                                               device=device, activations=act_quant)
            else:
                params = fuse_projections(init_params(config, gen, dtype=dtype, device=device))
        else:
            raise NotImplementedError(
                f"loading {ckpt_dir!r}: converting a Meta/HF checkpoint without jax "
                "is not ported yet (ROADMAP); use fabricated= or params="
            )
        self.llama = Llama(params, tokenizer, config, kv_quant=kv_quant)

    def _batcher(self):
        if self._cb is None:
            from prego_tpu_torch.serving_llm import ContinuousBatcher

            self._cb = ContinuousBatcher(
                self.llama, slots=self._cb_slots or self.llama.config.max_batch_size)
        return self._cb

    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]:
        if self._serving == "cb":
            # the anticipation dispatch (step_batch x num_samples^2 prompts
            # sharing a long context) through the slot loop: each request
            # retires on its own, the prefix KV shared through the LRU
            if max_gen_len is None:
                max_gen_len = self.llama.config.max_seq_len - 1
            tok = self.llama.tokenizer
            toks = [tok.encode(x, bos=True, eos=False) for x in prompts]
            outs = self._batcher().serve_prompts(toks, max_gen_len, temperature=temperature,
                                                 top_p=top_p)
            return [{"generation": tok.decode(t)} for t in outs]
        return self.llama.text_completion(
            prompts, temperature=temperature, top_p=top_p,
            max_gen_len=max_gen_len, use_prefix_cache=True,  # prompts share long prefixes
        )


def build_llm(name: str, **kwargs) -> CompletionLLM:
    return LLMS.get(name)(**kwargs)
