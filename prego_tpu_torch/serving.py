"""Online (strictly causal, frame-by-frame) mistake-detection serving
(port of prego_tpu/serving.py).

PREGO is defined as online detection, but the reference runs offline in
stages (full-video eval -> aggregate JSON -> anticipation script). This
module is the live composition of the same three components, frame in ->
verdict out, with the same math:

  OnlineRecognizer  - single-frame MiniROAD steps (models/miniroad.py
                      ``forward_step``, not K1) with the GRU state carried
                      per stream on the device;
  OnlineAggregator  - streaming TI-PREGO consensus: the modal class of
                      every completed fixed window (200 frames, bincount
                      tie-break: the lowest id), consecutive dedup; on
                      window boundaries this equals aggregate.py exactly;
  OnlineMistakeDetector - when the aggregated step sequence grows, ask the
                      LLM for the anticipated next steps from the history
                      and flag the new step if it is not among them
                      (llama_meta.py:14-58, the one-class rule).

Serving-scale paths, equal to the per-frame loop:
  * micro-batch: ``step_block`` / ``push_frames`` run N buffered frames on
    the device with the aggregator's state (per-class counts, window fill)
    carried there, and read the host once per block;
  * multi-stream: MultiStreamMistakeDetector serves B videos per block and
    sends all the LLM checks of a block in one ``text_completion`` call.

Frames come in as numpy. The recognizer runs on ``device`` (default the
card; ``"cpu"`` on request).

Spans (``core/profiling.annotate``, recorded only under a profiler), once a
block: ``prego.online.recognize`` the block's recognizer work (the frames
in, the block function, its one host read), ``prego.online.anticipate``
each ``text_completion`` call. The detectors keep the last block's
per-frame classes as ``last_ids``, on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Union

import numpy as np
import torch

from prego_tpu_torch.aggregate import WINDOW_SIZE
from prego_tpu_torch.anticipation.cleaning import clean_generation
from prego_tpu_torch.anticipation.llm import CompletionLLM
from prego_tpu_torch.anticipation.prompts import PromptBuilder
from prego_tpu_torch.core.device import resolve_device
from prego_tpu_torch.core.profiling import annotate
from prego_tpu_torch.models.miniroad import MiniROAD


def _tree_to(tree, device: torch.device):
    """A parameter tree (dicts and lists of tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Integer tensors on the host in ONE device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i : i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


class OnlineRecognizer:
    """Per-frame streaming step recognition over B concurrent streams."""

    def __init__(self, model: MiniROAD, params, batch: int = 1, flow_is_zero: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.model = model
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.batch = batch
        self.flow_is_zero = flow_is_zero
        self.hidden = model.init_hidden(batch, device=self.device)

    def _inputs(self, rgb: np.ndarray, flow: Optional[np.ndarray]):
        rgb_t = torch.as_tensor(np.asarray(rgb, np.float32)).to(self.device)
        if flow is None:
            flow_t = torch.zeros((*rgb_t.shape[:-1], self.model.flow_dim), device=self.device)
        else:
            flow_t = torch.as_tensor(np.asarray(flow, np.float32)).to(self.device)
        return rgb_t, flow_t

    def _step(self, rgb_t: torch.Tensor, flow_t: torch.Tensor) -> torch.Tensor:
        scores, self.hidden = self.model.forward_step(
            self.params, rgb_t, flow_t, self.hidden, flow_is_zero=self.flow_is_zero)
        return scores

    @torch.no_grad()
    def step(self, rgb: np.ndarray, flow: Optional[np.ndarray] = None) -> np.ndarray:
        """rgb: (B, D_rgb) one frame per stream -> argmax class ids (B,)."""
        return torch.argmax(self._step(*self._inputs(rgb, flow)), dim=-1).cpu().numpy()

    @torch.no_grad()
    def step_block(self, rgb: np.ndarray, flow: Optional[np.ndarray] = None) -> np.ndarray:
        """N buffered frames per stream, one host read for the block.

        rgb: (N, B, D_rgb) -> argmax class ids (N, B): the math of N
        ``step`` calls, the ids kept on the device until the block ends."""
        rgb_t, flow_t = self._inputs(rgb, flow)
        ids = [torch.argmax(self._step(rgb_t[t], flow_t[t]), dim=-1) for t in range(len(rgb_t))]
        return torch.stack(ids).cpu().numpy()

    def reset(self, stream: Optional[int] = None) -> None:
        if stream is None:
            self.hidden = self.model.init_hidden(self.batch, device=self.device)
        else:
            self.hidden = tuple(h.index_fill(0, torch.tensor([stream], device=h.device), 0.0)
                                for h in self.hidden)


class OnlineAggregator:
    """Streaming fixed-window majority vote + consecutive dedup."""

    def __init__(self, num_classes: int, window_size: int = WINDOW_SIZE):
        self.window_size = window_size
        self.counts = np.zeros(num_classes, np.int64)
        self.in_window = 0
        self.sequence: List[int] = []

    def push(self, class_id: int) -> Optional[int]:
        """Feed one recognized frame. Returns a NEW aggregated step id when
        a window completes and extends the deduped sequence, else None."""
        self.counts[class_id] += 1
        self.in_window += 1
        if self.in_window < self.window_size:
            return None
        return self._close_window()

    def flush(self) -> Optional[int]:
        """Close a trailing partial window (end of stream)."""
        if self.in_window == 0:
            return None
        return self._close_window()

    def _close_window(self) -> Optional[int]:
        winner = int(np.argmax(self.counts))  # lowest id wins ties (parity)
        self.counts[:] = 0
        self.in_window = 0
        if not self.sequence or self.sequence[-1] != winner:
            self.sequence.append(winner)
            return winner
        return None


def _make_detector_block_fn(model: MiniROAD, flow_is_zero: bool, window_size: int):
    """The micro-batch on the device: the GRU step and the windowed
    majority vote over N frames, the aggregator's state (counts (B, K)
    int32, window fill (B,) int32) carried on the device. Returns per
    frame (class, window completed, winner); the dedup and the LLM
    trigger stay on the host. ``torch.argmax`` takes the first maximum, the
    np.bincount-argmax parity rule (utils/aggregate.py:69-70)."""

    @torch.no_grad()
    def block_fn(params, rgb_block, flow_block, hidden, counts, in_window):
        # rgb_block: (N, B, D)
        cls_seq, done_seq, win_seq = [], [], []
        for t in range(rgb_block.shape[0]):
            scores, hidden = model.forward_step(params, rgb_block[t], flow_block[t], hidden,
                                                flow_is_zero=flow_is_zero)
            cls = torch.argmax(scores, dim=-1)  # (B,)
            counts = counts.scatter_add(1, cls[:, None], torch.ones_like(counts[:, :1]))
            in_window = in_window + 1
            completed = in_window >= window_size
            winner = torch.argmax(counts, dim=-1)
            counts = torch.where(completed[:, None], torch.zeros_like(counts), counts)
            in_window = torch.where(completed, torch.zeros_like(in_window), in_window)
            cls_seq.append(cls)
            done_seq.append(completed)
            win_seq.append(winner)
        out = (torch.stack(cls_seq), torch.stack(done_seq), torch.stack(win_seq))
        return out, hidden, counts, in_window

    return block_fn


@dataclass
class MistakeEvent:
    frame_index: int
    step: int
    history: List[int]
    anticipated: Set
    is_mistake: bool
    stream: int = 0


class OnlineMistakeDetector:
    """Frame in -> (optional) verdict out, single stream."""

    def __init__(
        self,
        recognizer: OnlineRecognizer,
        llm: CompletionLLM,
        context: str = "",
        toy: Optional[str] = None,
        toy_class: Optional[str] = None,
        type_prompt: str = "num",
        prompt_context: str = "default",
        num_samples: int = 1,
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = 8,
        window_size: int = WINDOW_SIZE,
        cleaning_mode: str = "meta",
    ):
        self.recognizer = recognizer
        self.llm = llm
        self.builder = PromptBuilder(
            context=context, toy=toy, toy_class=toy_class,
            type_prompt=type_prompt, prompt_context=prompt_context,
        )
        self.aggregator = OnlineAggregator(recognizer.model.num_classes, window_size)
        self.num_samples = num_samples
        self.temperature = temperature
        self.top_p = top_p
        self.max_gen_len = max_gen_len
        self.cleaning_mode = cleaning_mode
        self.frame_index = 0
        self.events: List[MistakeEvent] = []
        self._block_fn = None  # built on the first push_frames
        self.last_ids: Optional[torch.Tensor] = None  # (N,) the last block's classes

    def _check_step(self, step: int) -> MistakeEvent:
        seq = self.aggregator.sequence
        i = len(seq) - 1  # the step being checked
        prompt = self.builder.step_prompt(seq, i)
        prompts = [prompt] * (self.num_samples * self.num_samples)
        with annotate("prego.online.anticipate"):
            results = self.llm.text_completion(
                prompts, max_gen_len=self.max_gen_len,
                temperature=self.temperature, top_p=self.top_p,
            )
        anticipated = {
            clean_generation(r["generation"], self.builder.type_prompt, self.cleaning_mode)
            for r in results
        }
        event = MistakeEvent(
            frame_index=self.frame_index, step=step, history=list(seq[:i]),
            anticipated=anticipated, is_mistake=step not in anticipated,
        )
        self.events.append(event)
        return event

    def push_frame(self, rgb: np.ndarray, flow: Optional[np.ndarray] = None
                   ) -> Optional[MistakeEvent]:
        """rgb: (D_rgb,) one frame. Returns a MistakeEvent when a new
        aggregated step completes, else None."""
        class_id = int(self.recognizer.step(rgb[None], None if flow is None else flow[None])[0])
        self.frame_index += 1
        new_step = self.aggregator.push(class_id)
        if new_step is None:
            return None
        return self._check_step(new_step)

    def push_frames(self, rgb_block: np.ndarray, flow_block: Optional[np.ndarray] = None
                    ) -> List[MistakeEvent]:
        """N buffered frames with one host read (micro-batch serving).

        rgb_block: (N, D_rgb). The semantics of N push_frame calls: the GRU
        steps and the windowed majority vote run on the device with the
        aggregator's state carried there; only the consecutive dedup and
        the LLM calls happen on the host."""
        rec = self.recognizer
        if rec.batch != 1:
            raise ValueError(
                "push_frames drives a SINGLE stream; a recognizer built with "
                f"batch={rec.batch} would broadcast every stream's votes into one "
                "aggregator row: use MultiStreamMistakeDetector")
        if self._block_fn is None:
            self._block_fn = _make_detector_block_fn(rec.model, rec.flow_is_zero,
                                                     self.aggregator.window_size)
        N = rgb_block.shape[0]
        with annotate("prego.online.recognize"):
            rgb, flow = rec._inputs(rgb_block[:, None, :],
                                    None if flow_block is None else flow_block[:, None, :])
            counts = torch.as_tensor(
                self.aggregator.counts[None, :].astype(np.int32)).to(rec.device)
            in_w = torch.tensor([self.aggregator.in_window], dtype=torch.int32,
                                device=rec.device)
            (ids, completed, winner), rec.hidden, counts, in_w = self._block_fn(
                rec.params, rgb, flow, rec.hidden, counts, in_w)
            self.last_ids = ids[:, 0]
            completed, winner, counts, in_w = _fetch(completed[:, 0], winner[:, 0], counts[0],
                                                     in_w)
        self.aggregator.counts[:] = counts
        self.aggregator.in_window = int(in_w[0])
        events: List[MistakeEvent] = []
        for t in range(N):
            self.frame_index += 1
            if completed[t]:
                w = int(winner[t])
                if not self.aggregator.sequence or self.aggregator.sequence[-1] != w:
                    self.aggregator.sequence.append(w)
                    events.append(self._check_step(w))
        return events

    def finish(self) -> Optional[MistakeEvent]:
        """Flush the trailing partial window at end of stream."""
        new_step = self.aggregator.flush()
        if new_step is None:
            return None
        return self._check_step(new_step)


class MultiStreamMistakeDetector:
    """B concurrent video streams through one device block per N frames
    (recognition and each stream's windowed vote), with all the LLM checks
    of the block in one ``text_completion`` call.

    The same events as B independent OnlineMistakeDetectors: a stream's
    aggregated sequence grows whatever the verdict, so batching the LLM
    calls changes no event. Each stream may carry its own toy and context
    (per-stream PromptBuilder arguments)."""

    def __init__(
        self,
        recognizer: OnlineRecognizer,
        llm: CompletionLLM,
        stream_prompts: Optional[List[Dict]] = None,
        type_prompt: str = "num",
        prompt_context: str = "default",
        num_samples: int = 1,
        temperature: float = 0.6,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = 8,
        window_size: int = WINDOW_SIZE,
        cleaning_mode: str = "meta",
    ):
        B = recognizer.batch
        self.recognizer = recognizer
        self.llm = llm
        stream_prompts = stream_prompts or [{} for _ in range(B)]
        if len(stream_prompts) != B:
            raise ValueError(f"one prompt config per stream: {len(stream_prompts)} for {B}")
        self.builders = [
            PromptBuilder(type_prompt=type_prompt, prompt_context=prompt_context,
                          **{"context": "", **sp})
            for sp in stream_prompts
        ]
        self.aggregators = [OnlineAggregator(recognizer.model.num_classes, window_size)
                            for _ in range(B)]
        self.num_samples = num_samples
        self.temperature = temperature
        self.top_p = top_p
        self.max_gen_len = max_gen_len
        self.cleaning_mode = cleaning_mode
        self.frame_index = [0] * B
        self.events: List[List[MistakeEvent]] = [[] for _ in range(B)]
        self._block_fn = _make_detector_block_fn(recognizer.model, recognizer.flow_is_zero,
                                                 window_size)
        self.last_ids: Optional[torch.Tensor] = None  # (N, B) the last block's classes

    def _run_checks(self, checks: List[Dict]) -> List[MistakeEvent]:
        """checks: [{stream, frame_index, step, history}] -> events, with one
        LLM call for every check (num_samples^2 prompts each, the
        reference's duplicated-sampling distribution)."""
        if not checks:
            return []
        n_rep = self.num_samples * self.num_samples
        prompts: List[str] = []
        for c in checks:
            prompt = self.builders[c["stream"]].step_prompt(c["history"] + [c["step"]],
                                                            len(c["history"]))
            prompts.extend([prompt] * n_rep)
        with annotate("prego.online.anticipate"):
            results = self.llm.text_completion(
                prompts, max_gen_len=self.max_gen_len,
                temperature=self.temperature, top_p=self.top_p,
            )
        events = []
        for j, c in enumerate(checks):
            builder = self.builders[c["stream"]]
            anticipated = {
                clean_generation(r["generation"], builder.type_prompt, self.cleaning_mode)
                for r in results[j * n_rep : (j + 1) * n_rep]
            }
            event = MistakeEvent(
                frame_index=c["frame_index"], step=c["step"], history=c["history"],
                anticipated=anticipated, is_mistake=c["step"] not in anticipated,
                stream=c["stream"],
            )
            self.events[c["stream"]].append(event)
            events.append(event)
        return events

    def push_frames(self, rgb_block: np.ndarray, flow_block: Optional[np.ndarray] = None
                    ) -> List[MistakeEvent]:
        """rgb_block: (N, B, D_rgb), N frames for each of the B streams."""
        rec = self.recognizer
        N, B = rgb_block.shape[:2]
        if B != rec.batch:
            raise ValueError(f"push_frames: {B} streams for a recognizer of {rec.batch}")
        with annotate("prego.online.recognize"):
            rgb, flow = rec._inputs(rgb_block, flow_block)
            counts = torch.as_tensor(
                np.stack([a.counts for a in self.aggregators]).astype(np.int32)).to(rec.device)
            in_w = torch.as_tensor(
                np.array([a.in_window for a in self.aggregators], np.int32)).to(rec.device)
            (ids, completed, winner), rec.hidden, counts, in_w = self._block_fn(
                rec.params, rgb, flow, rec.hidden, counts, in_w)
            self.last_ids = ids
            completed, winner, counts, in_w = _fetch(completed, winner, counts, in_w)
        for b, agg in enumerate(self.aggregators):
            agg.counts[:] = counts[b]
            agg.in_window = int(in_w[b])
        checks: List[Dict] = []
        for t in range(N):
            for b in range(B):
                self.frame_index[b] += 1
                if completed[t, b]:
                    w = int(winner[t, b])
                    seq = self.aggregators[b].sequence
                    if not seq or seq[-1] != w:
                        checks.append({"stream": b, "frame_index": self.frame_index[b],
                                       "step": w, "history": list(seq)})
                        seq.append(w)
        return self._run_checks(checks)

    def finish(self, stream: Optional[int] = None) -> List[MistakeEvent]:
        """Flush trailing partial windows (all streams or one)."""
        streams = range(len(self.aggregators)) if stream is None else [stream]
        checks = []
        for b in streams:
            before = list(self.aggregators[b].sequence)
            new_step = self.aggregators[b].flush()
            if new_step is not None:
                checks.append({"stream": b, "frame_index": self.frame_index[b],
                               "step": new_step, "history": before})
        return self._run_checks(checks)

    def reset_stream(self, b: int) -> None:
        """Start a new video on stream b (recognizer state + aggregation)."""
        self.recognizer.reset(stream=b)
        self.aggregators[b] = OnlineAggregator(self.recognizer.model.num_classes,
                                               self.aggregators[b].window_size)
        self.frame_index[b] = 0
        self.events[b] = []
