"""Offline anticipation (PREGO's protocol): every step of every video of a
collection anticipated from its history, one completion call a video.

The entry the window drives is the port's ``anticipate_sequence`` with
``step_batch`` the video's step count, over ``TorchLlamaLLM`` serving the
batch path (``text_completion`` -> ``generate_with_prefix_cache``). The
closed loop has one caller. Every ``greedy_every``-th call is greedy
(temperature 0): its served tokens are what ``check`` holds against the
plain reference.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from perf_bench import gen, tracing, weights, yardstick
from perf_bench.loops import Check, limit_of
from perf_bench.reference import f32_exact
from perf_bench.reference import llama as ref_llama
from perf_bench.reference import prompts as ref_prompts


class ServedTokens:
    """The port's tokenizer, passed through, with the ids of every decode
    (one served completion each) kept in order."""

    def __init__(self, inner):
        self.inner = inner
        self.served: List[List[int]] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        return self.inner.encode(s, bos=bos, eos=eos)

    def decode(self, ids) -> str:
        self.served.append([int(i) for i in ids])
        return self.inner.decode(ids)


@dataclass
class Call:
    index: int
    toy: int
    seq: List[int]
    greedy: bool
    served: List[List[int]] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def rows(self) -> int:
        return len(self.seq)


def llama_config(c: dict, t: dict):
    """The port's LlamaConfig of the configuration file's ``llm`` block."""
    from prego_tpu_torch.models.llama.config import LlamaConfig

    cfg = LlamaConfig(dim=c["dim"], n_layers=c["n_layers"], n_heads=c["n_heads"],
                      n_kv_heads=c["n_kv_heads"], vocab_size=c["vocab_size"],
                      multiple_of=c["multiple_of"], ffn_dim_multiplier=c["ffn_dim_multiplier"],
                      norm_eps=c["norm_eps"], rope_theta=c["rope_theta"],
                      max_batch_size=t["max_batch_size"], max_seq_len=t["max_seq_len"])
    if cfg.ffn_hidden != c["ffn_hidden"] or cfg.head_dim != c["head_dim"]:
        raise ValueError(f"the port sizes the FFN {cfg.ffn_hidden} and heads {cfg.head_dim}; "
                         f"the configuration states {c['ffn_hidden']} and {c['head_dim']}")
    return cfg


def sample_requests(requests, prompt_of, served_of, seed: int, tokens: int):
    """(prompt ids, served ids) of a sample of ``requests`` drawn from the
    seed, the longest first, until ``tokens`` served tokens. A request
    served twice (the same prompt, greedy) is taken once."""
    if not requests:
        return [], []
    longest = max(range(len(requests)),
                  key=lambda k: len(prompt_of(*requests[k])) + len(served_of(*requests[k])))
    rng = np.random.default_rng([seed % (1 << 63), 7])
    order = [longest] + [int(k) for k in rng.permutation(len(requests)) if k != longest]
    prompts, served, seen, n = [], [], set(), 0
    for k in order:
        p, s = prompt_of(*requests[k]), served_of(*requests[k])
        if (tuple(p), tuple(s)) in seen:
            continue
        seen.add((tuple(p), tuple(s)))
        prompts.append(p)
        served.append(s)
        n += len(s)
        if n >= tokens:
            break
    return prompts, served


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.c = cell.config["llm"]
        self.t = cell.traffic
        self.calls: List[Call] = []
        self.traced_calls: List[Call] = []
        self.trace: Optional[tracing.Trace] = None
        self.window_s = 0.0
        self.attempted = self.failed = 0
        self.llm = None

    @property
    def unit_seconds(self) -> List[float]:
        return [c.seconds for c in self.calls]

    @property
    def unit_work(self) -> List[int]:
        return [c.rows for c in self.calls]

    # ---- set-up ----

    def setup(self) -> None:
        from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
        from prego_tpu_torch.anticipation.prompts import PromptBuilder

        # the port's sampler stream, from the seed
        os.environ["PREGO_SAMPLE_SEED"] = str(self.seed % (1 << 31))
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.tree = weights.llama_tree(self.c, self.seed, self.device, dtype)
        self.llm = TorchLlamaLLM(params=self.tree, config=llama_config(self.c, self.t),
                                 device=str(self.device), serving="batch")
        self.tokens = ServedTokens(self.llm.llama.tokenizer)
        self.llm.llama.tokenizer = self.tokens
        self.coll = gen.make_collection(self.t, self.seed)
        self.prompters = [PromptBuilder(context=ctx, toy=toy)
                         for ctx, toy in zip(self.coll.contexts, self.coll.toys)]
        for i in range(int(self.t["warmup_calls"])):
            self._call(i)

    def _call(self, i: int) -> Call:
        from prego_tpu_torch.anticipation.driver import anticipate_sequence

        toy, seq = self.coll.videos[i % len(self.coll.videos)]
        greedy = i % int(self.t["greedy_every"]) == 0
        call = Call(index=i, toy=toy, seq=seq, greedy=greedy)
        first = len(self.tokens.served)
        t0 = time.perf_counter()
        anticipate_sequence(seq, self.prompters[toy], self.llm,
                            max_gen_len=int(self.t["max_gen_len"]),
                            temperature=0.0 if greedy else float(self.t["temperature"]),
                            top_p=float(self.t["top_p"]), num_samples=1,
                            step_batch=len(seq))
        call.seconds = time.perf_counter() - t0
        call.served = self.tokens.served[first:]
        return call

    # ---- the window ----

    def window(self, seconds: float, tracer: Optional[tracing.Tracer] = None) -> None:
        units = int(self.t["trace_units"])
        t0 = time.perf_counter()
        i = 0
        while True:
            if tracer is not None and i == 0:
                tracer.start()
            with tracing.span("call"):
                call = self._call(i)
            self.calls.append(call)
            self.attempted += call.rows
            if tracer is not None and tracer.active and i + 1 == units:
                tracer.stop()
                self.traced_calls = list(self.calls)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        if tracer is not None and tracer.active:
            tracer.stop()
            self.traced_calls = list(self.calls)

    def end_to_end(self) -> dict:
        checks = sum(c.rows for c in self.calls)
        return {"checks_per_s": (checks / self.window_s, "checks/s")}

    def release(self) -> None:
        self.llm = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    # ---- what the per-layer readers use ----

    def prompt_ids(self, call: Call) -> List[List[int]]:
        ctx, toy = self.coll.contexts[call.toy], self.coll.toys[call.toy]
        return [ref_prompts.ids(ref_prompts.step_prompt(ctx, toy, call.seq, i))
                for i in range(len(call.seq))]

    def call_flops(self, call: Call) -> float:
        return yardstick.llama_call_flops(self.c, self.prompt_ids(call),
                                          [len(s) for s in call.served])

    # ---- correctness ----

    def check(self) -> List[Check]:
        """The greedy requests the window finished, a sample drawn from the
        seed with the longest among them, against the float32 reference:
        the mean, over the sample's served tokens, of the gap by which a
        served token's logit lies below the reference's best. Every prompt
        must have had its answer."""
        f32_exact()
        missing = sum(max(c.rows - len(c.served), 0) for c in self.calls)
        requests = [(c, j) for c in self.calls if c.greedy for j in range(len(c.served))]
        ids = {}

        def prompt(c, j):
            if c.index not in ids:
                ids[c.index] = self.prompt_ids(c)
            return ids[c.index][j]

        prompts, served = sample_requests(requests, prompt, lambda c, j: c.served[j],
                                          self.seed, int(self.t["check_tokens"]))
        self.checked = (prompts, served)
        self.gaps = ref_llama.served_gaps(
            self.tree, self.c, prompts, served, eos=ref_prompts.EOS,
            max_gen=int(self.t["max_gen_len"])) if prompts else []
        flat = [g for row in self.gaps for g in row]
        mean = sum(flat) / len(flat) if flat else float("nan")
        return [Check("mean_gap", mean, limit_of(self.cell.limits, "mean_gap")),
                Check("missing_answers", float(missing), 0.0)]
