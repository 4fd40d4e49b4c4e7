"""LLM seam for step anticipation (port of prego_tpu/anticipation/llm.py).

Every backend answers ``text_completion(prompts, max_gen_len,
temperature, top_p)`` with ``{"generation": str}`` dicts, the prompt echo
stripped (llama/generation.py:233-282). Here:

  * FakeLLM: the deterministic next-symbol oracle for hermetic runs;
  * HFPipelineLLM (``hf``): a transformers text-generation pipeline on a
    device of its own (transformers is imported on first build);
  * OllamaLLM (``ollama``): the chat API of an Ollama server over HTTP;
  * TorchLlamaLLM (``torch-llama``): the port's LLaMA decoder on one
    device, in the single-card fused layout (wqkv, w13), bf16 on the card;
    ``quantize="int8"`` serves int8 weights (K4), ``"int8x8"`` int8 weights
    and per-token int8 activations (K5), ``kv_quant`` an int8 KV cache (K3);
    ``serving="cb"`` routes every call through the continuous-batching
    slot loop (``serving_llm.ContinuousBatcher``, ``cb_slots`` slots);
    ``spec_k`` with ``spec_draft`` decodes speculatively
    (``models/llama/speculative.py``) on the batch path. A DeepSeek-V2
    model (a ``DeepseekV2Config``: ``params=`` with ``config=``, or
    ``fabricated="dsv2-lite"``) is served as its tree comes, bf16 on one
    card through ``serving="batch"``; ``quantize``, ``kv_quant``,
    ``serving="cb"``, ``spec_k`` and ``tp`` refuse it.

TorchLlamaLLM takes its weights from a Meta checkpoint directory
(``params.json`` and ``consolidated.*.pth``) or an HF export
(``config.json`` and safetensors or ``pytorch_model*.bin``) through
``checkpoint/convert.py`` (``ckpt_dir=`` with ``tokenizer_path=``), as
random weights at a reference shape (``fabricated=``), or as parameters
handed over through ``checkpoint/bridge.py`` (``params=`` with
``config=``). A converted tree is fused (wqkv, w13) and, under
``quantize``, quantized on the device it serves from. ``orbax_dir`` names
a cache of converted weights for a Meta directory, written and read by
``checkpoint/params_io.py`` (the JAX adapter's Orbax cache,
prego_tpu/anticipation/llm.py:307-353, 404-423): with ``quantize="int8"``
it holds the fused int8 serving tree, and later builds restore the int8
tensors straight onto the device, with no conversion and no bf16 stage.

Tensor parallelism (``tp``, the JAX adapter's, prego_tpu/anticipation/
llm.py:297-307, 374-403): a checkpoint directory served by ranks of
``torch.distributed`` (``python -m torch.distributed.run``) is split over
``tp`` of them, by default the whole world in bf16 and 1 under
``quantize`` (int8 on one card is the flagship layout). With ``tp`` > 1
every rank serves its blocks of the UNfused tree (``parallel/``): the
int8 leaves quantized from the unfused tree rather than restored from a
fused int8 cache, a bf16 cache restored rank by rank. Every rank takes
part in every call and gets the same completions. Fabricated shapes and
``params=`` trees ignore ``tp``, as the JAX adapter's early return does.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
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


def import_transformers():
    """transformers for a PyTorch model. Unless the environment says
    otherwise, it is told to load neither TensorFlow nor Flax: where those
    are installed, its pipelines import them, and through them jax."""
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers

    return transformers


@LLMS.register("hf")
class HFPipelineLLM:
    """transformers text-generation pipeline adapter (llm_hf.py:24-58).

    The pipeline echoes the prompt unless asked not to; every backend
    honours the same no-echo contract. Greedy where ``temperature`` is 0.
    The pipeline runs on ``device``: the card by default, which raises
    where there is none (``core/device.py``). An injected ``pipe`` is used
    as given."""

    def __init__(self, model_name: str, device: str = "cuda", pipe=None):
        if pipe is not None:
            self.pipe = pipe
            return
        device = resolve_device(device)  # before the heavy import
        self.pipe = import_transformers().pipeline(
            "text-generation", model=model_name, tokenizer=model_name, device=device)

    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]:
        do_sample = temperature > 0
        kwargs = {"max_new_tokens": max_gen_len, "do_sample": do_sample,
                  "return_full_text": False}
        if do_sample:
            kwargs.update(temperature=temperature, top_p=top_p)
        out = []
        for res in self.pipe(prompts, **kwargs):
            if isinstance(res, list):
                res = res[0]
            out.append({"generation": res["generated_text"]})
        return out


@LLMS.register("ollama")
class OllamaLLM:
    """Ollama chat adapter (llm_ollama.py:76-145): one request a prompt to
    ``{host}/api/chat`` over urllib (no ollama package), with the
    reference's system message that asks for a single number."""

    SYSTEM = (
        "Always provide only the final output, consisting in one and only "
        "one number. Never output anything different from a single number."
    )

    def __init__(self, model_name: str, host: str = "http://127.0.0.1:11434"):
        self.model_name = model_name
        self.host = host.rstrip("/")

    def _chat(self, prompt: str, temperature: float, top_p: float, max_gen_len):
        import urllib.request

        body = {
            "model": self.model_name,
            "stream": False,
            "messages": [{"role": "system", "content": self.SYSTEM},
                         {"role": "user", "content": prompt}],
            "options": {"temperature": temperature, "top_p": top_p,
                        **({"num_predict": max_gen_len} if max_gen_len else {})},
        }
        req = urllib.request.Request(f"{self.host}/api/chat", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())["message"]["content"]

    def text_completion(
        self,
        prompts: List[str],
        max_gen_len: Optional[int] = None,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[Dict[str, str]]:
        return [{"generation": self._chat(p, temperature, top_p, max_gen_len)} for p in prompts]


# reference serving shapes (llama/model.py:20-31 and the 7B/13B checkpoints
# of Llama.build); "1b" and "tiny" are small stand-ins
FABRICATED_SHAPES = {
    "7b": dict(dim=4096, n_layers=32, n_heads=32),
    "13b": dict(dim=5120, n_layers=40, n_heads=40),
    "1b": dict(dim=2048, n_layers=16, n_heads=16),
    "tiny": dict(dim=64, n_layers=2, n_heads=4),
}
# DeepSeek-V2 shapes: DeepSeek-V2-Lite at its published widths and depth, and
# the CPU tests' miniature
LATENT_FABRICATED = ("dsv2-lite", "dsv2-tiny")


def fabricated_config(shape: str, max_seq_len: int, max_batch_size: int, n_layers=None):
    """The LlamaConfig of a fabricated shape (the JAX adapter's
    ``_init_fabricated``); ``n_layers`` cuts depth, widths stay. The
    DeepSeek-V2 shapes give a ``DeepseekV2Config``."""
    import dataclasses

    from prego_tpu_torch.models.llama.config import (
        LlamaConfig, deepseek_v2_lite_config, tiny_deepseek_v2_config,
    )

    if shape in LATENT_FABRICATED:
        make = deepseek_v2_lite_config if shape == "dsv2-lite" else tiny_deepseek_v2_config
        cfg = make(max_seq_len=max_seq_len, max_batch_size=max_batch_size)
        return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg
    s = FABRICATED_SHAPES[shape]
    return LlamaConfig(
        dim=s["dim"], n_layers=n_layers or s["n_layers"], n_heads=s["n_heads"],
        n_kv_heads=s["n_heads"], vocab_size=32000 if shape in ("7b", "13b") else 258,
        multiple_of=256 if shape != "tiny" else 16, norm_eps=1e-5,
        max_batch_size=max_batch_size, max_seq_len=max_seq_len,
    )


def load_checkpoint_dir(ckpt_dir: str, tokenizer, max_seq_len: int, max_batch_size: int,
                        dtype, device, orbax_dir: Optional[str] = None, quantize=False,
                        mesh=None):
    """(params, LlamaConfig) of a Meta directory (``params.json``, the
    vocabulary from the tokenizer) or an HF export (``config.json``), built
    on ``device`` (the JAX adapter's checkpoint branch,
    prego_tpu/anticipation/llm.py:269-423). With a tensor-parallel
    ``mesh`` (axis ``tp``), ``_load_sharded``.

    A Meta directory's tree comes back unfused in ``dtype`` without
    ``quantize``, and fused and quantized with it. ``orbax_dir`` (Meta
    directories only, as in the JAX adapter) caches the conversion:
      * present, ``quantize="int8"``, an int8 cache: the int8 tree restored
        directly (no conversion, no quantization);
      * present, ``quantize`` on, a bf16 cache: restored, then quantized;
      * present, ``quantize`` off: restored (an int8 cache raises);
      * absent, ``quantize`` off: converted, then saved;
      * absent, ``quantize="int8"``: converted, quantized, then the int8
        serving tree saved. Nothing is saved under ``"int8x8"``.
    """
    from prego_tpu_torch.checkpoint import convert, params_io
    from prego_tpu_torch.models.llama import model
    from prego_tpu_torch.models.llama.config import LlamaConfig

    if not osp.isdir(ckpt_dir):
        raise FileNotFoundError(
            f"ckpt_dir {ckpt_dir!r} does not exist (expected a Meta checkpoint dir with "
            "params.json or an HF export with config.json)")
    act_quant = quantize == "int8x8"
    if mesh is not None:
        return _load_sharded(ckpt_dir, tokenizer, max_seq_len, max_batch_size, dtype, device,
                             orbax_dir, quantize, mesh)
    if osp.exists(osp.join(ckpt_dir, "params.json")):
        config = LlamaConfig.from_params_json(ckpt_dir, max_seq_len=max_seq_len,
                                              max_batch_size=max_batch_size,
                                              vocab_size=tokenizer.n_words)
        cached = bool(orbax_dir) and osp.isdir(orbax_dir)
        if cached:
            stored = params_io.read_manifest(orbax_dir)
            if quantize and not act_quant and stored["quantized"]:
                # the serving tree itself: int8 straight onto the device
                return params_io.load_llama_params(orbax_dir, config, device, dtype,
                                                   quantized=True), config
            params = params_io.load_llama_params(orbax_dir, config, device, dtype)
        else:
            params = convert.convert_meta_checkpoint(ckpt_dir, config, dtype, device)
            if orbax_dir and not quantize:
                params_io.save_llama_params(orbax_dir, params, config)
        if quantize:
            params = model.quantize_params(model.fuse_projections(params),
                                           activations=act_quant)
            if orbax_dir and not cached and not act_quant:
                # later builds restore the int8 tree; the int8 x int8 marker
                # is structural, so that layout is not cached
                params_io.save_llama_params(orbax_dir, params, config)
        return params, config
    config = _hf_config(ckpt_dir, max_seq_len, max_batch_size)
    return convert.convert_hf_checkpoint(ckpt_dir, config, dtype, device), config


def _hf_config(ckpt_dir: str, max_seq_len: int, max_batch_size: int):
    from prego_tpu_torch.models.llama.config import LlamaConfig

    with open(osp.join(ckpt_dir, "config.json")) as f:
        hf = json.load(f)
    return LlamaConfig(
        dim=hf["hidden_size"], n_layers=hf["num_hidden_layers"],
        n_heads=hf["num_attention_heads"], n_kv_heads=hf.get("num_key_value_heads"),
        vocab_size=hf["vocab_size"], norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0), max_seq_len=max_seq_len,
        max_batch_size=max_batch_size,
    )


def _load_sharded(ckpt_dir, tokenizer, max_seq_len, max_batch_size, dtype, device, orbax_dir,
                  quantize, mesh):
    """This rank's blocks of a checkpoint directory's unfused tree over the
    ``tp`` axis of ``mesh``, and the config that serves them
    (``llama_tp_config``). A Meta directory's bf16 cache in ``orbax_dir``
    is restored block by block; without one, the tree is converted (and
    cached by rank 0 unless ``quantize``). Under ``quantize`` the int8
    leaves are quantized from the unfused tree, never restored from the
    fused int8 cache (the JAX adapter converts fresh too)."""
    import torch.distributed as dist

    from prego_tpu_torch.checkpoint import convert, params_io
    from prego_tpu_torch.models.llama import model
    from prego_tpu_torch.models.llama.config import LlamaConfig
    from prego_tpu_torch.parallel import llama_param_specs, llama_tp_config, shard_params

    act_quant = quantize == "int8x8"
    if osp.exists(osp.join(ckpt_dir, "params.json")):
        config = LlamaConfig.from_params_json(ckpt_dir, max_seq_len=max_seq_len,
                                              max_batch_size=max_batch_size,
                                              vocab_size=tokenizer.n_words)
        tp_config = llama_tp_config(config, mesh)  # raises before any read
        if orbax_dir and osp.isdir(orbax_dir) and not quantize:
            return params_io.load_llama_params(orbax_dir, config, device, dtype,
                                               mesh=mesh), tp_config
        params = convert.convert_meta_checkpoint(ckpt_dir, config, dtype, device)
        if orbax_dir and not osp.isdir(orbax_dir) and not quantize:
            if dist.get_rank() == 0:
                params_io.save_llama_params(orbax_dir, params, config)
            dist.barrier()
    else:
        config = _hf_config(ckpt_dir, max_seq_len, max_batch_size)
        tp_config = llama_tp_config(config, mesh)
        params = convert.convert_hf_checkpoint(ckpt_dir, config, dtype, device)
    if quantize:
        params = model.quantize_params(params, activations=act_quant)
    specs = llama_param_specs(config, quantized=bool(quantize), activations=act_quant)
    return shard_params(params, specs, mesh), tp_config


@LLMS.register("torch-llama")
class TorchLlamaLLM:
    """The port's LLaMA backend (the counterpart of ``jax-llama``)."""

    def __init__(
        self,
        ckpt_dir: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        max_seq_len: int = 512,
        max_batch_size: int = 8,
        fabricated: Optional[str] = None,  # "7b"/"13b"/"1b"/"tiny", "dsv2-lite"/
        # "dsv2-tiny" (DeepSeek-V2): random weights
        orbax_dir: Optional[str] = None,  # cache of a Meta directory's converted
        # weights (checkpoint/params_io.py); with quantize="int8" the int8
        # serving tree, restored directly by later builds
        params=None,  # the port's parameter dict (checkpoint/bridge.py)
        config=None,  # its LlamaConfig, required with params
        device: str = "cuda",  # raises where there is no card; "cpu" on request
        quantize=False,  # False | True/"int8" (weight-only) | "int8x8" (int8 x int8)
        kv_quant: bool = False,  # int8 KV cache
        serving: str = "batch",  # "batch": drain-style generate (reference
        # semantics); "cb": every text_completion through the
        # continuous-batching slot loop (serving_llm.ContinuousBatcher)
        cb_slots: Optional[int] = None,  # cb slot count (default max_batch_size)
        spec_k: int = 0,  # > 0: speculative decoding with k-token drafts; greedy
        # output equals the plain path's for any draft, sampled output keeps
        # its distribution
        spec_draft: Optional[str] = None,  # "self-N" (the target's first N
        # layers, its own tensors), "fabricated-1b" / "fabricated-tiny"
        # (random weights: acceptance ~0), or a Meta checkpoint dir
        tp: Optional[int] = None,  # tensor-parallel ranks for ckpt_dir: default the
        # initialized world in bf16, 1 under quantize
    ):
        from prego_tpu_torch.models.llama import ByteTokenizer, Llama, load_tokenizer
        from prego_tpu_torch.models.llama.config import is_latent, refuse_latent
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
        if spec_k and serving == "cb":
            raise ValueError("speculative decoding rides the batch path (spec_k is "
                             "incompatible with --serving cb)")
        if bool(spec_k) != (spec_draft is not None):
            raise ValueError("spec_k and spec_draft must be set together")
        if fabricated in LATENT_FABRICATED:
            config = fabricated_config(fabricated, max_seq_len, max_batch_size)
        # DeepSeek-V2 serves in bf16 through the batch path only
        for on, what in ((quantize, f"quantize={quantize!r}"), (kv_quant, "kv_quant"),
                         (serving == "cb", "serving='cb'"), (spec_k, "spec_k"),
                         (tp is not None and tp > 1, f"tp={tp}")):
            if on and config is not None:
                refuse_latent(config, what)
        self._serving = serving
        self._cb_slots = cb_slots
        self._cb = None  # built on the first cb call
        self._spec_k = int(spec_k)
        self._spec_draft = spec_draft
        self._spec = None  # built on the first call
        # the guard of the JAX adapter (prego_tpu/anticipation/llm.py:
        # 233-262): once 256 proposals have been judged, an acceptance below
        # PREGO_SPEC_MIN_ACCEPT (default 1/k; 0 turns the guard off) sends
        # the rest of the run to the plain path
        self._spec_disabled = False
        default = 1.0 / spec_k if spec_k else 0.0
        env = os.environ.get("PREGO_SPEC_MIN_ACCEPT")
        try:
            self._spec_min_accept = float(env) if env is not None else default
        except ValueError:
            print(f"prego_tpu_torch: ignoring unparsable PREGO_SPEC_MIN_ACCEPT={env!r}; "
                  "using 1/k", file=sys.stderr)
            self._spec_min_accept = default
        device = resolve_device(device)
        self.device = device
        # bf16 is the serving dtype on the card; the CPU path runs f32, as
        # the JAX package does off the TPU
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.dtype = dtype
        if ckpt_dir is not None and params is None and fabricated is None:
            if not tokenizer_path:
                raise ValueError("ckpt_dir= needs tokenizer_path= (a tokenizer file, or 'byte')")
            tokenizer = load_tokenizer(tokenizer_path)
            from prego_tpu_torch.parallel.mesh import tp_mesh, world_size

            if tp is None:
                tp = 1 if quantize else world_size()
            mesh = tp_mesh(tp) if tp > 1 else None
            # converted, fused and quantized on the serving device: the card
            # holds a 7B bf16 tree beside its int8 copy, and does the
            # transposes and the quantization far faster than the host
            params, config = load_checkpoint_dir(ckpt_dir, tokenizer, max_seq_len,
                                                 max_batch_size, dtype, device,
                                                 orbax_dir=orbax_dir, quantize=quantize,
                                                 mesh=mesh)
        else:
            tokenizer = load_tokenizer(tokenizer_path) if tokenizer_path else ByteTokenizer()
        if getattr(config, "tp_group", None) is not None:
            pass  # this rank's blocks of the unfused tree, quantized where asked
        elif params is not None:
            if config is None:
                raise ValueError("params= needs config=")
            # DeepSeek-V2's tree is served as it comes
            if not is_latent(config) and "wqkv" not in params["layers"][0]["attention"]:
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
            elif is_latent(config):  # DeepSeek-V2's serving tree
                params = init_params(config, gen, dtype=dtype, device=device)
            else:
                params = fuse_projections(init_params(config, gen, dtype=dtype, device=device))
        else:
            raise ValueError("TorchLlamaLLM needs ckpt_dir=, fabricated= or params=")
        self.llama = Llama(params, tokenizer, config, kv_quant=kv_quant)

    def _speculator(self):
        """The SpeculativeLlama of ``spec_draft`` over this model, built once."""
        if self._spec is None:
            from prego_tpu_torch.checkpoint.convert import convert_meta_checkpoint
            from prego_tpu_torch.models.llama.config import LlamaConfig
            from prego_tpu_torch.models.llama.model import fuse_projections, init_params
            from prego_tpu_torch.models.llama.speculative import SpeculativeLlama, self_draft

            cfg, draft = self.llama.config, self._spec_draft
            if draft.startswith("self-"):
                # the target's first N layers, its own tensors: no weight copied
                d_params, d_cfg = self_draft(self.llama.params, cfg, int(draft[len("self-"):]))
            elif draft.startswith("fabricated-"):
                s = FABRICATED_SHAPES[draft[len("fabricated-"):]]
                d_cfg = LlamaConfig(
                    dim=s["dim"], n_layers=s["n_layers"], n_heads=s["n_heads"],
                    n_kv_heads=s["n_heads"], vocab_size=cfg.vocab_size,
                    multiple_of=256 if s["dim"] >= 256 else 16, norm_eps=1e-5,
                    max_batch_size=cfg.max_batch_size, max_seq_len=cfg.max_seq_len,
                )
                gen = torch.Generator(device=self.device)
                gen.manual_seed(11)
                d_params = fuse_projections(init_params(d_cfg, gen, dtype=self.dtype,
                                                        device=self.device))
            else:  # a Meta checkpoint dir: the target's vocabulary
                d_cfg = LlamaConfig.from_params_json(
                    draft, max_seq_len=cfg.max_seq_len, max_batch_size=cfg.max_batch_size,
                    vocab_size=cfg.vocab_size)
                d_params = fuse_projections(convert_meta_checkpoint(draft, d_cfg, self.dtype,
                                                                     self.device))
            self._spec = SpeculativeLlama(self.llama, d_params, d_cfg, k=self._spec_k)
        return self._spec

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
        if self._spec_k and not self._spec_disabled:
            spec = self._speculator()
            out = spec.text_completion(prompts, temperature=temperature, top_p=top_p,
                                       max_gen_len=max_gen_len, use_prefix_cache=True)
            # the auto-off guard, judged once 256 proposals are in
            if (self._spec_min_accept > 0 and spec.drafts_proposed >= 256
                    and spec.drafts_accepted < self._spec_min_accept * spec.drafts_proposed):
                self._spec_disabled = True
                print(
                    "prego_tpu_torch: speculative decoding auto-disabled — acceptance "
                    f"{spec.drafts_accepted}/{spec.drafts_proposed} = "
                    f"{spec.drafts_accepted / spec.drafts_proposed:.3f} is below break-even "
                    f"(~{self._spec_min_accept:.2f} at k={self._spec_k}); continuing on the "
                    "plain path (PREGO_SPEC_MIN_ACCEPT=0 disables this guard)",
                    file=sys.stderr,
                )
            return out
        return self.llama.text_completion(
            prompts, temperature=temperature, top_p=top_p,
            max_gen_len=max_gen_len, use_prefix_cache=True,  # prompts share long prefixes
        )


def build_llm(name: str, **kwargs) -> CompletionLLM:
    return LLMS.get(name)(**kwargs)
