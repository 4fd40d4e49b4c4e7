"""Online mistake detection beside live cameras: many streams through one
card, block by block.

Set-up builds the port's ``OnlineRecognizer`` (MiniROAD's per-frame
``forward_step``, the GRU state of every stream on the card) and a
``MultiStreamMistakeDetector`` over ``TorchLlamaLLM`` (the batch path),
each stream with its toy's context. The window drives
``push_frames`` with one block of ``block_frames`` frames of every
stream at a time, in a closed loop: the next block goes in after the
previous block's verdicts. A block's new steps are checked in one
completion call. When a stream's video ends, ``reset_stream`` starts the
next. Every ``greedy_every``-th block is greedy (temperature 0), for the
check of its served tokens.
"""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from perf_bench import gen, tracing, weights
from perf_bench.loops import Check, limit_of
from perf_bench.loops.anticipate import ServedTokens, llama_config, sample_requests
from perf_bench.reference import f32_exact
from perf_bench.reference import llama as ref_llama
from perf_bench.reference import miniroad as ref_mr
from perf_bench.reference import prompts as ref_prompts
from perf_bench.reference import vote as ref_vote


class TimedLLM:
    """The LLM handed to the detector, passed through, with the host clock
    of its calls and the prompts of the last one."""

    def __init__(self, llm):
        self.llm = llm
        self.seconds = 0.0
        self.last_prompts: List[str] = []

    def text_completion(self, prompts, max_gen_len=None, temperature=0.6, top_p=0.9):
        t0 = time.perf_counter()
        with tracing.span("llm"):
            out = self.llm.text_completion(prompts, max_gen_len=max_gen_len,
                                           temperature=temperature, top_p=top_p)
        self.seconds += time.perf_counter() - t0
        self.last_prompts = list(prompts)
        return out


@dataclass
class Block:
    index: int
    greedy: bool
    events: list
    served: List[List[int]]
    ids: Optional[torch.Tensor]  # the recognizer's class of every frame, (N, B), on the card
    seconds: float = 0.0
    llm_seconds: float = 0.0
    prompt_count: int = 0
    traced: bool = False


def recognizer_config(rc: dict):
    from prego_tpu_torch.core import RecognitionConfig

    return RecognitionConfig.from_dict({k: rc[k] for k in (
        "model", "rgb_type", "flow_type", "embedding_dim", "hidden_dim", "num_layers",
        "num_classes", "dropout")})


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.c = cell.config["llm"]
        self.rc = cell.config["recognizer"]
        self.t = cell.traffic
        self.blocks: List[Block] = []
        self.trace = None
        self.window_s = 0.0
        self.attempted = self.failed = 0

    @property
    def unit_seconds(self) -> List[float]:
        return [b.seconds for b in self.blocks]

    @property
    def unit_work(self) -> List[int]:
        return [len(b.events) for b in self.blocks]

    @property
    def traced_calls(self) -> List[Block]:
        return [b for b in self.blocks if b.traced]

    def setup(self) -> None:
        from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
        from prego_tpu_torch.models.miniroad import MiniROAD
        from prego_tpu_torch.serving import MultiStreamMistakeDetector, OnlineRecognizer

        t, rc = self.t, self.rc
        os.environ["PREGO_SAMPLE_SEED"] = str(self.seed % (1 << 31))
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.tree = weights.llama_tree(self.c, self.seed, self.device, dtype)
        llm = TorchLlamaLLM(params=self.tree, config=llama_config(self.c, t),
                            device=str(self.device), serving="batch")
        self.tokens = ServedTokens(llm.llama.tokenizer)
        llm.llama.tokenizer = self.tokens
        self.llm = TimedLLM(llm)
        self.rparams = weights.miniroad_tree(rc, self.seed + 1, self.device)
        self.r0 = {k: v.detach().clone() for k, v in ref_mr.flat(self.rparams).items()}
        rec = OnlineRecognizer(MiniROAD(recognizer_config(rc)), self.rparams,
                               batch=int(t["streams"]), flow_is_zero=True, device=self.device)
        self.toys, self.contexts = gen.make_contexts(t, self.seed)
        self.streams = gen.make_streams(t, self.seed, rc["num_classes"], rc["rgb_dim"])
        prompts = [{"context": self.contexts[k], "toy": self.toys[k]}
                   for k in self.streams.toy_of]
        self.det = MultiStreamMistakeDetector(
            rec, self.llm, stream_prompts=prompts, max_gen_len=int(t["max_gen_len"]),
            temperature=float(t["temperature"]), top_p=float(t["top_p"]),
            window_size=int(t["block_frames"]))
        block_fn = self.det._block_fn
        self._ids: List[torch.Tensor] = []

        def recorded(*args):  # keeps each frame's class, on the card
            out = block_fn(*args)
            self._ids.append(out[0][0])
            return out

        self.det._block_fn = recorded
        for k in range(int(t["warmup_blocks"])):
            self._block(k)
        # the window starts every stream's first video afresh (block 0)

    def _block(self, k: int) -> Block:
        K = len(self.streams.features)
        for b in self.streams.starts[k % K]:
            self.det.reset_stream(b)
        greedy = k % int(self.t["greedy_every"]) == 0
        self.det.temperature = 0.0 if greedy else float(self.t["temperature"])
        first, llm0 = len(self.tokens.served), self.llm.seconds
        self.llm.last_prompts = []
        t0 = time.perf_counter()
        with tracing.span("block"):
            events = self.det.push_frames(self.streams.features[k % K])
        blk = Block(index=k, greedy=greedy, events=list(events),
                    served=self.tokens.served[first:], ids=self._ids[-1],
                    seconds=time.perf_counter() - t0, llm_seconds=self.llm.seconds - llm0,
                    prompt_count=len(self.llm.last_prompts))
        return blk

    def window(self, seconds: float, tracer: Optional[tracing.Tracer] = None) -> None:
        units = int(self.t["trace_units"])
        t0 = time.perf_counter()
        k = 0
        while True:
            if tracer is not None and k == 0:
                tracer.start()
            blk = self._block(k)
            blk.traced = tracer is not None and tracer.active
            self.blocks.append(blk)
            if tracer is not None and tracer.active and k + 1 == units:
                tracer.stop()
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        if tracer is not None and tracer.active:
            tracer.stop()
        self.attempted = len(self.blocks) * int(self.t["streams"]) * int(self.t["block_frames"])

    def end_to_end(self) -> dict:
        frames = len(self.blocks) * int(self.t["streams"]) * int(self.t["block_frames"])
        return {"online_frames_per_s": (frames / self.window_s, "frames/s")}

    def release(self) -> None:
        self.det = self.llm = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    # ---- what the per-layer readers use ----

    def check_prompt_ids(self, c: Dict) -> List[int]:
        k = self.streams.toy_of[c["stream"]]
        seq = list(c["history"]) + [c["step"]]
        return ref_prompts.ids(ref_prompts.step_prompt(self.contexts[k], self.toys[k], seq,
                                                       len(c["history"])))

    def prompt_ids(self, blk: Block) -> List[List[int]]:
        return [self.check_prompt_ids({"stream": e.stream, "history": e.history, "step": e.step})
                for e in blk.events]

    # ---- correctness ----

    def reference_ids(self, dtype=torch.float32) -> List[torch.Tensor]:
        """The reference recognizer's class of every frame of the window's
        blocks, replayed from the window's start (every stream's first
        video starts with block 0), states zeroed where a video starts."""
        p = {k: v.to(dtype) for k, v in self.r0.items()}
        K = len(self.streams.features)
        B = int(self.t["streams"])
        h = torch.zeros(B, self.rc["hidden_dim"], dtype=dtype, device=self.device)
        out = []
        for blk in self.blocks:
            starts = self.streams.starts[blk.index % K]
            if starts:
                h = h.clone()
                h[torch.as_tensor(starts, device=self.device)] = 0
            x = torch.as_tensor(self.streams.features[blk.index % K], device=self.device)
            ids, h = ref_mr.stream_ids(p, x, h, self.rc["rgb_dim"])
            out.append(ids)
        return out

    def vote_checks(self) -> List[List[Dict]]:
        """The checks the reference vote raises from the port's own per-frame
        classes: each block is one window of every stream."""
        K = len(self.streams.features)
        N, B = int(self.t["block_frames"]), int(self.t["streams"])
        seqs: List[List[int]] = [[] for _ in range(B)]
        frames = [0] * B
        out = []
        for blk in self.blocks:
            ids = blk.ids.cpu().numpy()
            for b in self.streams.starts[blk.index % K]:
                seqs[b], frames[b] = [], 0
            checks = []
            for b in range(B):
                checks += ref_vote.window_checks(ids[:, b], seqs[b], frames[b], N, b)
                frames[b] += N
            out.append(checks)
        return out

    def check(self) -> List[Check]:
        """The recognizer's classes against the float32 reference (the share
        of frames that differ); the vote and the verdicts from the port's
        own classes, exactly; every check answered; and, on the greedy
        blocks, the mean gap of the served tokens below the float32 LLM
        reference's best, as in the anticipation cell."""
        f32_exact()
        ref_ids = self.reference_ids()
        diff = sum(int((b.ids != r).sum()) for b, r in zip(self.blocks, ref_ids))
        total = sum(b.ids.numel() for b in self.blocks)
        self.id_mismatch = diff / max(total, 1)
        votes = self.vote_checks()
        vote_bad = verdict_bad = missing = 0
        for blk, want in zip(self.blocks, votes):
            got = [{"stream": e.stream, "frame_index": e.frame_index, "step": e.step,
                    "history": list(e.history)} for e in blk.events]
            vote_bad += int(got != want)
            verdict_bad += sum(e.is_mistake != ref_vote.verdict(e.step, e.anticipated)
                               for e in blk.events)
            missing += max(blk.prompt_count - len(blk.served), 0)
        requests = [(blk, j) for blk in self.blocks if blk.greedy
                    for j in range(min(len(blk.served), len(blk.events)))]
        prompts, served = sample_requests(
            requests, lambda blk, j: self.check_prompt_ids(
                {"stream": blk.events[j].stream, "history": blk.events[j].history,
                 "step": blk.events[j].step}),
            lambda blk, j: blk.served[j], self.seed, int(self.t["check_tokens"]))
        self.checked = (prompts, served)
        self.gaps = ref_llama.served_gaps(
            self.tree, self.c, prompts, served, eos=ref_prompts.EOS,
            max_gen=int(self.t["max_gen_len"])) if prompts else []
        flat = [g for row in self.gaps for g in row]
        mean = sum(flat) / len(flat) if flat else float("nan")
        lim = self.cell.limits
        return [Check("id_mismatch", self.id_mismatch, limit_of(lim, "id_mismatch")),
                Check("vote_mismatch", float(vote_bad), 0.0),
                Check("verdict_mismatch", float(verdict_bad), 0.0),
                Check("missing_answers", float(missing), 0.0),
                Check("mean_gap", mean, limit_of(lim, "mean_gap"))]
