"""Batched LLaMA generation: prefill + single-token decode loop (port of
prego_tpu/models/llama/generation.py).

Parity surface: Llama.generate / Llama.text_completion
(llama/generation.py:127-282) and Llama.chat_completion (the LLaMA-2
[INST]/<<SYS>> format, generation.py:284-395):
  * left-aligned prompts padded with pad_id into a (B, total_len) buffer;
  * per-prompt eos tracked only on generated positions; the loop ends
    when every row has emitted eos (generation.py:208-212);
  * host-side post-processing cuts echo, max_gen_len and eos.

The JAX package starts every row's decode at the batch's shortest prompt
and feeds the longer rows' prompt tokens one step at a time
(input_text_mask, generation.py:204-207). Here the prefill of the whole
buffer already holds every row's prompt K/V and its last prompt token's
logits, so every row's decode starts at its own prompt end: where the
prompts' lengths differ, at per-row positions (``forward``'s (B,)
start_pos), and the loop runs max_gen_len steps, not max_gen_len plus
the longest prompt less the shortest. Greedy tokens are the JAX
package's; a sampled row draws from the same distributions, from fewer
draws of the stream.

The JAX package runs the decode loop as one jitted while_loop. Here it is
a Python loop whose per-token work stays on the device: the token buffer,
the eos flags and the sampler's draws never come back to the host inside
the loop, except for an all-rows-done check every ``EOS_CHECK_EVERY``
tokens (rows that are done only append pad, so running a few steps past
the last eos changes no output). Prompts share their longest common
prefix through an LRU of B=1 prefix caches, as in the JAX package. With
``kv_quant`` every cache, the fresh ones and those of the prefix LRU, is
the int8 cache of ``init_cache(quantized=True)``.

Every call decodes over the first B rows of one persistent cache of
``max_batch_size`` rows and max_seq_len + 1 positions (``load_rows``: a
call that needs the spare tail views all of it, every other call the
first max_seq_len positions of the same memory), which the call loads
with the prefix (or zeroes) and its prefill writes. On the card, a call
at per-row positions without a tp group (``replays_decode``) replays its
single-token forward from a captured CUDA graph over those rows, so a
step costs the host a few launches, not one a kernel. One graph a (B, T,
``fusion_gates()``), made when a call first meets that key: its step 0
runs eagerly, then the forward is captured and steps 1 on replay it. The
graphs share one memory pool and replay in stream order on the current
stream. The sampler, the eos flags and the token buffer stay eager, so
the sampler's stream of draws is the eager loop's, and so are the bits:
the same kernels run in the same order. Every other call, and the CPU,
runs every step eagerly.

Spans (``core/profiling.annotate``, recorded only under a profiler):
``prego.generate.prefix`` where a prefix entry is built or extended,
``prego.generate.prefill`` the prompt or suffix forward,
``prego.generate.step`` each decode step (under replay the host's
enqueueing of the step, not its device time), ``prego.generate.capture``
inside the step that captures a graph, ``prego.generate.readback`` the
call's one read of the tokens. Counters (host integers, from lengths the
host holds): ``prefix_rebuilds``, ``prefix_extends``, ``decode_steps``,
``decode_graph_captures``, ``decode_graph_replays`` (the steps of
``decode_steps`` that replayed a graph), ``prefix_tokens_reused``,
``suffix_tokens_prefilled`` and ``per_row_calls``. No step feeds a prompt
token, so no ``prego.generate.tail_step`` span opens.

``Llama`` owns the prefix cache and the request front for every loop that
serves it (this one, ``speculative.py`` and ``serving_llm.py``): the
shared-prefix rule (``shared_prefix``, ``aligned_prefix``), the LRU
(``ensure_prefix``, ``lookup_prefix``), and the module's ``split_batch``,
``cut_row`` and ``round_up``.

DeepSeek-V2 (a ``DeepseekV2Config``) is served by the same code over its
latent cache. Its MoE counters: every forward of a call (prefix builds,
prefill, decode steps) copies each MoE layer's expert offsets into a slot
of one device buffer, made once; the host reads the call's slots right
after its read-back of the tokens, so no step waits for them, and keeps
``moe_assignments`` (token-expert pairs), ``moe_expert_hits`` (the sum over
layer-forwards of the experts that got a row), ``moe_rows_max`` (the sum
of the busiest expert's rows) and ``moe_last_counts``, the last call's
rows (forward, MoE layer, expert). A LLaMA config has no buffer.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prego_tpu_torch.core.profiling import annotate
from prego_tpu_torch.core.seed import make_generator
from prego_tpu_torch.models.llama.config import LlamaConfig, is_latent, refuse_latent
from prego_tpu_torch.models.llama.model import (
    Cache,
    Params,
    clone_cache,
    forward,
    fusion_gates,
    init_cache,
    load_rows,
    precompute_rope,
)
from prego_tpu_torch.ops._cuda import CudaKernel
from prego_tpu_torch.ops.sampling import sample_next_token


# the LLaMA-2 chat format (llama/generation.py:43-48)
B_INST, E_INST = "[INST]", "[/INST]"
B_SYS, E_SYS = "<<SYS>>\n", "\n<</SYS>>\n\n"
SPECIAL_TAGS = [B_INST, E_INST, "<<SYS>>", "<</SYS>>"]
UNSAFE_ERROR = "Error: special tags are not allowed as part of the prompt."


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def split_batch(rows: Sequence, size: int) -> List[Sequence]:
    """``rows`` in consecutive slices of at most ``size``: a batch over
    max_batch_size runs as several (the reference asserts,
    generation.py:160)."""
    return [rows[i : i + size] for i in range(0, len(rows), size)]


def cut_row(toks: List[int], pad_id: int, eos_id: int,
            probs: Optional[List[float]] = None) -> Tuple[List[int], Optional[List[float]]]:
    """The host cut of a generated row: at its first pad (padding or the
    fill after eos), then at its first eos; ``probs``, where given, with it."""
    for stop in (pad_id, eos_id):
        if stop in toks:
            n = toks.index(stop)
            toks, probs = toks[:n], None if probs is None else probs[:n]
    return toks, probs


def replays_decode(device: torch.device, per_row: bool, config: LlamaConfig) -> bool:
    """Whether a call replays its single-token forward from a captured CUDA
    graph over its rows of the persistent cache: on the card, at per-row
    positions (a scalar position is a Python int that slices the rope and
    the cache, and may pick K8 or K8u), without a tp group (whose
    collectives stay eager). Every other call runs every step eagerly."""
    return device.type == "cuda" and per_row and getattr(config, "tp_group", None) is None


class _DecodeGraph:
    """One captured single-token ``forward`` over fixed rows of a
    persistent cache: static inputs, the (B, 1) tokens, the (B,) int32
    positions and, for DeepSeek-V2, the (MoE layers, experts) int32
    counters, and the static output, f32 logits (B, 1, V). A kernel
    wrapper counts its launch when the capture records it, and a replay
    launches without the wrapper: the capture's counts are taken back and
    added again on every replay, so ``CudaKernel.launches`` counts the
    launches the card makes."""

    def __init__(self, llama: "Llama", cache: Cache, batch: int):
        dev = llama.device
        self.tokens = torch.zeros(batch, 1, dtype=torch.int64, device=dev)
        self.positions = torch.zeros(batch, dtype=torch.int32, device=dev)
        offsets = llama._moe_offsets
        self.counts = None if offsets is None else torch.zeros_like(offsets[0])
        self.graph = torch.cuda.CUDAGraph()
        # captured on a side stream (the default stream cannot capture),
        # into the pool every graph of this model shares
        stream, pool = llama._capture_target()
        before = {k: k.launches for k in CudaKernel.instances}
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            self.logits, _ = forward(llama.params, self.tokens, self.positions, cache,
                                     llama.config, llama.rope, self.counts)
            self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.launches = [(k, k.launches - before.get(k, 0)) for k in CudaKernel.instances
                         if k.launches > before.get(k, 0)]
        for k, n in self.launches:  # the capture ran nothing
            k.launches -= n

    def replay(self, tokens: torch.Tensor, positions: torch.Tensor,
               counts: Optional[torch.Tensor]) -> torch.Tensor:
        """The logits of one step, replayed on the current stream; the
        step's MoE counters go to ``counts``."""
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        self.graph.replay()
        for k, n in self.launches:
            k.launches += n
        if counts is not None:
            counts.copy_(self.counts)
        return self.logits


class Llama:
    """User-facing generation wrapper (Llama.build/text_completion parity)
    with KV prefix caching: the PREGO anticipation loop sends the same
    few-shot context many times per video, so the shared prompt prefix is
    prefilled once (B=1, 256-token chunks) and decode resumes from the
    cached KV."""

    PREFIX_CHUNK = 64  # granularity of the shared prefix that is cached
    PREFIX_BUILD_CHUNK = 256  # prefill chunk when building a prefix cache
    EOS_CHECK_EVERY = 8  # decode steps between host checks for all-done

    def __init__(
        self,
        params: Params,
        tokenizer,
        config: LlamaConfig,
        pad_to_multiple: int = 64,
        kv_quant: bool = False,
        prefix_cache_slots: int = 4,
    ):
        self.params = params
        self.tokenizer = tokenizer
        self.config = config
        self.device = params["norm"].device
        self.dtype = params["norm"].dtype
        self.pad_to_multiple = pad_to_multiple  # token buffers are rounded up to this length
        self.kv_quant = kv_quant  # int8 KV cache (model.init_cache(quantized=True))
        self.rope = precompute_rope(config, device=self.device)
        # generation.py:95 seeds 1; PREGO_SAMPLE_SEED varies the sampling
        # stream, as in the JAX package (its noise-floor controls)
        self.generator = make_generator(int(os.environ.get("PREGO_SAMPLE_SEED", "1")),
                                        self.device)
        # LRU entries; each holds a B=1 cache of every layer
        self.prefix_cache_slots = max(1, int(prefix_cache_slots))
        self._prefix_caches: "OrderedDict[Tuple[int, ...], Cache]" = OrderedDict()
        self.prefix_rebuilds = 0  # observability: from-scratch prefill count
        self.prefix_extends = 0  # observability: delta-prefill count
        self.decode_steps = 0  # single-token forwards run (all rows at once)
        # prompt tokens of the rows served from a cached prefix's KV (ServeStats' name)
        self.prefix_tokens_reused = 0
        # prompt tokens of the rows through the prompt or suffix forward (ServeStats' name)
        self.suffix_tokens_prefilled = 0
        self.per_row_calls = 0  # calls decoded at per-row positions (ragged prompts)
        self.decode_graph_captures = 0  # single-token forwards captured as CUDA graphs
        self.decode_graph_replays = 0  # decode steps run by replaying one
        # the cache of max_batch_size rows every call decodes over, made on first use
        self._decode_cache: Optional[Cache] = None
        # (B, T, fusion_gates()) -> its captured step over the first B rows
        self._decode_graphs: Dict[Tuple, _DecodeGraph] = {}
        self._capture: Optional[Tuple] = None  # (side stream, pool), made on first use
        self.moe_assignments = self.moe_expert_hits = self.moe_rows_max = 0
        self.moe_last_counts: Optional[np.ndarray] = None  # (forwards, MoE layers, experts)
        self._moe_offsets: Optional[torch.Tensor] = None
        self._moe_forwards = 0  # slots of the buffer this call has filled
        if is_latent(config):
            if kv_quant:
                refuse_latent(config, "the int8 KV cache (kv_quant)")
            # a call's forwards: its prefix chunks, the prefill and its steps
            slots = 2 + config.max_seq_len + -(-config.max_seq_len // self.PREFIX_BUILD_CHUNK)
            self._moe_offsets = torch.zeros(slots, config.n_moe_layers, config.n_routed_experts,
                                            dtype=torch.int32, device=self.device)

    def _moe_slot(self) -> Optional[torch.Tensor]:
        """The next forward's (MoE layers, experts) slot of the counters'
        buffer; None for a LLaMA config."""
        if self._moe_offsets is None:
            return None
        slot = self._moe_offsets[self._moe_forwards]
        self._moe_forwards += 1
        return slot

    def _moe_collect(self) -> None:
        """Reads this call's slots (after its read-back: nothing waits) into
        the MoE counters."""
        if not self._moe_forwards:
            return
        offs = self._moe_offsets[: self._moe_forwards].cpu().numpy().astype(np.int64)
        self._moe_forwards = 0
        counts = np.diff(offs, axis=-1, prepend=0)
        self.moe_last_counts = counts
        self.moe_assignments += int(counts.sum())
        self.moe_expert_hits += int((counts > 0).sum())
        self.moe_rows_max += int(counts.max(axis=-1).sum())

    def _new_cache(self, batch: int, spare: int = 0) -> Cache:
        """A zero cache of this model's kind; ``spare`` positions past
        max_seq_len for speculative decoding (``speculative.py``)."""
        return init_cache(self.config, batch, dtype=self.dtype, device=self.device,
                          quantized=self.kv_quant, spare=spare)

    def _capture_target(self) -> Tuple:
        """The side stream this model's graphs are captured on, and the
        memory pool they share."""
        if self._capture is None:
            self._capture = (torch.cuda.Stream(self.device), torch.cuda.graph_pool_handle())
        return self._capture

    def _decode_rows(self, batch: int, spare: int, prefix: Optional[Cache]) -> Cache:
        """A call's cache of ``batch`` rows and T = max_seq_len + ``spare``
        positions in the persistent cache's memory, loaded with ``prefix``
        (or zeroed)."""
        if self._decode_cache is None:
            self._decode_cache = self._new_cache(self.config.max_batch_size, spare=1)
        return load_rows(self._decode_cache, batch, self.config.max_seq_len + spare, prefix)

    # -- the decode loop --

    @torch.no_grad()
    def _generate_body(
        self,
        prompts: List[List[int]],  # each row's prompt tokens past the offset
        max_gen_len: int,
        prefix: Optional[Cache],  # a B=1 cache holding the offset's K/V, or None
        start_offset: int,  # absolute position of each prompt's first token
        temperature: float,
        top_p: float,
        want_logprobs: bool,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The (B, buf_len) pad-filled buffer of prompts and generated tokens
        and, with ``want_logprobs``, each token's f32 logprob (0 at column 0
        and past the generated tokens). One prefill of the whole buffer
        writes every row's prompt K/V and gives each row's first logits at
        its own last prompt token. Row i's t-th token goes to column
        len_i + t and is fed at position start_offset + len_i + t: one
        scalar position where every prompt has the same length, else a
        (B,) device tensor of per-row positions (``forward``). A row whose
        next column lies past the cache emits pad, and its feeds land in a
        one-position spare tail of the cache, never over a live key."""
        config = self.config
        eos_id, pad_id = int(self.tokenizer.eos_id), int(self.tokenizer.pad_id)
        dev = self.device
        B = len(prompts)
        lens = [len(p) for p in prompts]
        min_len, max_len = min(lens), max(lens)
        room = config.max_seq_len - start_offset  # cache positions past the offset
        total_len = min(room, max_gen_len + max_len)
        buf_len = min(round_up(total_len, self.pad_to_multiple), room)
        buf = np.full((B, buf_len), pad_id, np.int64)
        for i, p in enumerate(prompts):
            buf[i, : len(p)] = np.asarray(p, np.int64)
        if min_len == total_len:  # nothing to generate (generation.py:179-186 edge)
            self._moe_collect()
            return buf, (np.zeros((B, buf_len), np.float32) if want_logprobs else None)
        steps = min(max_gen_len, room - min_len)  # the shortest row's tokens
        per_row = min_len != max_len
        spare = int(max_len + steps > room)  # a row runs out of cache before the loop ends
        cache = self._decode_rows(B, spare, prefix)
        graphs = replays_decode(dev, per_row, config)
        key = (B, config.max_seq_len + spare, fusion_gates())
        graph = self._decode_graphs.get(key) if graphs else None
        tokens = torch.from_numpy(buf).to(dev)
        with annotate("prego.generate.prefill"):
            prefill_logits, cache = forward(
                self.params, tokens, start_offset, cache, config, self.rope, self._moe_slot()
            )
        self.suffix_tokens_prefilled += sum(lens)
        lens_t = torch.tensor(lens, device=dev) if per_row or want_logprobs else None
        past_end = None
        if per_row:
            self.per_row_calls += 1
            last_logits = prefill_logits[torch.arange(B, device=dev), lens_t - 1]
            ahead = lens_t[None, :] + torch.arange(steps, device=dev)[:, None]  # (steps, B)
            positions = (start_offset + ahead).to(torch.int32)  # step t's, row by row
            if spare:
                past_end = ahead >= room
        else:
            last_logits = prefill_logits[:, min_len - 1]
        if want_logprobs:
            # prompt-token logprobs: position i+1 scored by the prefill's logits at i
            lp = torch.log_softmax(prefill_logits[:, :-1], dim=-1)
            gathered = torch.gather(lp, -1, tokens[:, 1:, None].clamp(min=0))[..., 0]
            in_prompt = torch.arange(1, buf_len, device=dev)[None, :] < lens_t[:, None]
            prompt_lp = torch.where(in_prompt, gathered, torch.zeros_like(gathered))
            gen_lp = torch.zeros(B, steps, dtype=torch.float32, device=dev)
        gen = torch.full((B, steps), pad_id, dtype=torch.int64, device=dev)
        eos_reached = torch.zeros(B, dtype=torch.bool, device=dev)
        pad = torch.full((B,), pad_id, dtype=torch.int64, device=dev)
        for t in range(steps):
            with annotate("prego.generate.step"):
                next_token = sample_next_token(last_logits, temperature, top_p, self.generator)
                if past_end is not None:  # rows past the cache's end are done
                    eos_reached |= past_end[t]
                next_token = torch.where(eos_reached, pad, next_token)
                gen[:, t] = next_token
                if want_logprobs:
                    lp_t = torch.log_softmax(last_logits, dim=-1)
                    gen_lp[:, t] = torch.gather(lp_t, -1, next_token[:, None].clamp(min=0))[:, 0]
                eos_reached |= next_token == eos_id
                pos = positions[t] if per_row else start_offset + min_len + t
                if graph is not None:
                    logits = graph.replay(next_token[:, None], pos, self._moe_slot())
                    self.decode_graph_replays += 1
                else:
                    logits, cache = forward(
                        self.params, next_token[:, None], pos, cache, config, self.rope,
                        self._moe_slot()
                    )
                    if graphs:  # a new key: this eager step was its warm-up
                        with annotate("prego.generate.capture"):
                            graph = self._decode_graphs[key] = _DecodeGraph(self, cache, B)
                        self.decode_graph_captures += 1
                self.decode_steps += 1
                last_logits = logits[:, 0]
                # the all-rows-done check before every EOS_CHECK_EVERY-th next
                # step, inside this step's span: the host waits there
                done = ((t + 1) % self.EOS_CHECK_EVERY == 0 and t + 1 < steps
                        and bool(eos_reached.all()))
            if done:
                break
        with annotate("prego.generate.readback"):  # one read-back per call
            gen_np = gen.cpu().numpy()
            if want_logprobs:
                prompt_lp_np, gen_lp_np = prompt_lp.cpu().numpy(), gen_lp.cpu().numpy()
        self._moe_collect()
        lp_out = None
        if want_logprobs:
            lp_out = np.zeros((B, buf_len), np.float32)
            lp_out[:, 1:] = prompt_lp_np
        for i, n in enumerate(lens):
            k = min(steps, buf_len - n)  # a row stops at the buffer's (the cache's) end
            buf[i, n : n + k] = gen_np[i, :k]
            if want_logprobs:
                lp_out[i, n : n + k] = gen_lp_np[i, :k]
        return buf, lp_out

    # -- low level --

    def generate(
        self,
        prompt_tokens: List[List[int]],
        max_gen_len: int,
        temperature: float = 0.6,
        top_p: float = 0.9,
        echo: bool = False,
        logprobs: bool = False,
    ) -> Tuple[List[List[int]], Optional[List[List[float]]]]:
        config = self.config
        parts = split_batch(prompt_tokens, config.max_batch_size)
        if len(parts) > 1:
            runs = [self.generate(p, max_gen_len, temperature, top_p, echo, logprobs)
                    for p in parts]
            return ([t for toks, _ in runs for t in toks],
                    [lp for _, lps in runs for lp in lps] if logprobs else None)
        max_prompt_len = max(len(t) for t in prompt_tokens)
        if max_prompt_len > config.max_seq_len:
            raise ValueError(f"prompt of {max_prompt_len} tokens exceeds max_seq_len")
        out, lp = self._generate_body(prompt_tokens, max_gen_len, None, 0, float(temperature),
                                      float(top_p), logprobs)

        out_tokens, out_logprobs = [], []
        for i, toks in enumerate(out.tolist()):
            start = 0 if echo else len(prompt_tokens[i])
            stop = len(prompt_tokens[i]) + max_gen_len
            probs = lp[i].tolist()[start:stop] if logprobs else []
            toks, probs = cut_row(toks[start:stop], self.tokenizer.pad_id,
                                  self.tokenizer.eos_id, probs)
            out_tokens.append(toks)
            out_logprobs.append(probs)
        return out_tokens, (out_logprobs if logprobs else None)

    # -- the prefix cache --

    def aligned_prefix(self, n: int) -> int:
        """``n`` rounded down to ``PREFIX_CHUNK``, the granularity of the
        cached prefixes: 0 below one chunk."""
        return (n // self.PREFIX_CHUNK) * self.PREFIX_CHUNK

    def shared_prefix(self, prompt_tokens: Sequence[Sequence[int]]) -> int:
        """The length of the batch's prefix that the LRU serves: the
        prompts' longest common prefix, at least one token short of the
        shortest prompt (the suffix prefill gives the first logits, and a
        speculative verify re-feeds that token), rounded down to
        ``PREFIX_CHUNK``; 0 below one chunk."""
        first = prompt_tokens[0]
        common = min(len(t) for t in prompt_tokens)
        shared = 0
        while shared < common - 1 and all(t[shared] == first[shared] for t in prompt_tokens):
            shared += 1
        return self.aligned_prefix(shared)

    def lookup_prefix(self, tokens: Sequence[int], touch: bool = True
                      ) -> Tuple[int, Optional[Cache]]:
        """The longest LRU key that prefixes ``tokens`` (all of them
        included), as (its length, its B=1 cache); (0, None) if none.
        ``touch`` marks the entry most recently used."""
        tokens = tuple(tokens)
        best = None
        for k in self._prefix_caches:
            if len(k) <= len(tokens) and tokens[: len(k)] == k:
                if best is None or len(k) > len(best):
                    best = k
        if best is None:
            return 0, None
        if touch:
            self._prefix_caches.move_to_end(best)
        return len(best), self._prefix_caches[best]

    @torch.no_grad()
    def ensure_prefix(self, prefix: Tuple[int, ...]) -> Cache:
        """The LRU's B=1 cache of ``prefix``'s K/V, touched where it is held,
        else built: from the longest cached entry that prefixes it (cloned,
        so that entry stays valid; not touched) or from scratch, then
        inserted, evicting the least recent past ``prefix_cache_slots``."""
        cached = self._prefix_caches.get(prefix)
        if cached is not None:
            self._prefix_caches.move_to_end(prefix)  # LRU touch
            return cached
        start, base = self.lookup_prefix(prefix, touch=False)
        with annotate("prego.generate.prefix"):
            if base is not None:
                cache = clone_cache(base)
                self.prefix_extends += 1
            else:
                cache = self._new_cache(1)
                self.prefix_rebuilds += 1
            T = self.config.max_seq_len
            step = min(self.PREFIX_BUILD_CHUNK, T)
            buf = np.asarray(prefix, np.int64)
            for i in range(start, len(prefix), step):
                # the pad-filled tail writes only past the prefix, and stops
                # at the cache's end (the JAX package's update clamps the
                # chunk's start instead, which moves an extension's K/V to
                # the wrong positions when i + step > max_seq_len)
                width = min(step, T - i)
                chunk = buf[i : i + width]
                if len(chunk) < width:
                    chunk = np.concatenate(
                        [chunk, np.full(width - len(chunk), self.tokenizer.pad_id, np.int64)]
                    )
                _, cache = forward(
                    self.params, torch.from_numpy(chunk[None, :]).to(self.device), i,
                    cache, self.config, self.rope, self._moe_slot(),
                )
        self._prefix_caches[prefix] = cache
        while len(self._prefix_caches) > self.prefix_cache_slots:
            self._prefix_caches.popitem(last=False)  # evict least-recent
        return cache

    def generate_with_prefix_cache(
        self,
        prompt_tokens: List[List[int]],
        max_gen_len: int,
        temperature: float = 0.6,
        top_p: float = 0.9,
    ) -> List[List[int]]:
        """Generate completions reusing the KV of the batch-common prompt
        prefix; plain ``generate`` when that prefix is shorter than one
        PREFIX_CHUNK. Returns generated (non-echo) tokens."""
        parts = split_batch(prompt_tokens, self.config.max_batch_size)
        if len(parts) > 1:
            return [t for p in parts
                    for t in self.generate_with_prefix_cache(p, max_gen_len, temperature, top_p)]
        if max(len(t) for t in prompt_tokens) > self.config.max_seq_len:
            raise ValueError("prompt exceeds max_seq_len")
        eff = self.shared_prefix(prompt_tokens)
        if not eff:
            return self.generate(prompt_tokens, max_gen_len, temperature, top_p)[0]

        cache1 = self.ensure_prefix(tuple(prompt_tokens[0][:eff]))
        suffixes = [t[eff:] for t in prompt_tokens]
        # the B=1 prefix KV is copied to the batch; decode writes per row
        self.prefix_tokens_reused += len(prompt_tokens) * eff
        out, _ = self._generate_body(suffixes, max_gen_len, cache1, eff, float(temperature),
                                     float(top_p), False)
        return [cut_row(toks[len(s) : len(s) + max_gen_len], self.tokenizer.pad_id,
                        self.tokenizer.eos_id)[0]
                for s, toks in zip(suffixes, out.tolist())]

    # -- reference seam --

    def text_completion(
        self,
        prompts: List[str],
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = None,
        logprobs: bool = False,
        echo: bool = False,
        use_prefix_cache: bool = False,
    ) -> List[Dict]:
        if max_gen_len is None:
            max_gen_len = self.config.max_seq_len - 1
        prompt_tokens = [self.tokenizer.encode(x, bos=True, eos=False) for x in prompts]
        if use_prefix_cache and not logprobs and not echo:
            generation_tokens = self.generate_with_prefix_cache(
                prompt_tokens, max_gen_len=max_gen_len, temperature=temperature, top_p=top_p,
            )
            return [{"generation": self.tokenizer.decode(t)} for t in generation_tokens]
        generation_tokens, generation_logprobs = self.generate(
            prompt_tokens, max_gen_len=max_gen_len, temperature=temperature,
            top_p=top_p, echo=echo, logprobs=logprobs,
        )
        if logprobs:
            return [
                {
                    "generation": self.tokenizer.decode(t),
                    "tokens": [self.tokenizer.decode([x]) for x in t],
                    "logprobs": lp,
                }
                for t, lp in zip(generation_tokens, generation_logprobs)
            ]
        return [{"generation": self.tokenizer.decode(t)} for t in generation_tokens]

    def chat_dialog_tokens(self, dialog: List[Dict[str, str]]) -> List[int]:
        """A dialog's prompt in the LLaMA-2 chat format (generation.py:
        284-395): the system message folded into the first user turn
        inside ``<<SYS>>``, each user/assistant exchange ``[INST] .. [/INST]
        ..`` with bos and eos, the last user turn left open. Raises
        ValueError where the roles do not alternate (the reference asserts)."""
        if dialog[0]["role"] == "system":
            dialog = [{"role": dialog[1]["role"],
                       "content": B_SYS + dialog[0]["content"] + E_SYS + dialog[1]["content"]}
                      ] + dialog[2:]
        if not (all(m["role"] == "user" for m in dialog[::2])
                and all(m["role"] == "assistant" for m in dialog[1::2])):
            raise ValueError("roles must alternate user/assistant (optionally system first)")
        toks: List[int] = []
        for prompt, answer in zip(dialog[::2], dialog[1::2]):
            toks += self.tokenizer.encode(
                f"{B_INST} {prompt['content'].strip()} {E_INST} {answer['content'].strip()} ",
                bos=True, eos=True)
        if dialog[-1]["role"] != "user":
            raise ValueError("last message must be from user")
        toks += self.tokenizer.encode(f"{B_INST} {dialog[-1]['content'].strip()} {E_INST}",
                                      bos=True, eos=False)
        return toks

    def chat_completion(
        self,
        dialogs: List[List[Dict[str, str]]],
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = None,
        logprobs: bool = False,
    ) -> List[Dict]:
        """LLaMA-2 chat completion over ``generate``: each dialog's prompt
        from ``chat_dialog_tokens``; a dialog whose content injects any of
        ``SPECIAL_TAGS`` gets ``UNSAFE_ERROR`` as its content
        (generation.py:47-48, 324-327, 379-393); logprobs as in
        ``text_completion``."""
        if max_gen_len is None:
            max_gen_len = self.config.max_seq_len - 1
        unsafe = [any(tag in msg["content"] for tag in SPECIAL_TAGS for msg in d) for d in dialogs]
        generation_tokens, generation_logprobs = self.generate(
            [self.chat_dialog_tokens(d) for d in dialogs], max_gen_len=max_gen_len,
            temperature=temperature, top_p=top_p, logprobs=logprobs,
        )
        out = []
        for i, (t, bad) in enumerate(zip(generation_tokens, unsafe)):
            item = {"generation": {"role": "assistant",
                                   "content": UNSAFE_ERROR if bad else self.tokenizer.decode(t)}}
            if logprobs:
                item["tokens"] = [self.tokenizer.decode([x]) for x in t]
                item["logprobs"] = generation_logprobs[i]
            out.append(item)
        return out
