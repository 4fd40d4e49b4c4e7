"""Online serving, port against prego_tpu: the recognizer's per-frame ids on
the same frames and parameters (through the bridge), the streaming
aggregator against offline aggregation, push_frames against a loop of
push_frame, and the multi-stream detector against B single-stream
detectors, under FakeLLM and under the LLaMA backends in batch and cb
mode."""

import jax
import numpy as np
import pytest
import torch

from prego_tpu.anticipation import FakeLLM as JaxFakeLLM
from prego_tpu.anticipation.llm import JaxLlamaLLM
from prego_tpu.core import RecognitionConfig as JaxRecognitionConfig
from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
from prego_tpu.serving import MultiStreamMistakeDetector as JaxMulti
from prego_tpu.serving import OnlineAggregator as JaxAggregator
from prego_tpu.serving import OnlineMistakeDetector as JaxDetector
from prego_tpu.serving import OnlineRecognizer as JaxRecognizer
from prego_tpu_torch.aggregate import aggregate_video
from prego_tpu_torch.anticipation import FakeLLM, TorchLlamaLLM
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, miniroad_from_numpy
from prego_tpu_torch.core import RecognitionConfig
from prego_tpu_torch.models.llama import LlamaConfig
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.serving import (
    MultiStreamMistakeDetector,
    OnlineAggregator,
    OnlineMistakeDetector,
    OnlineRecognizer,
)

RAW = {
    "rgb_type": "rgb_kinetics_bninception",
    "flow_type": "flow_anet_resnet50",
    "embedding_dim": 32,
    "hidden_dim": 16,
    "num_layers": 1,
    "num_classes": 5,
    "dropout": 0.0,
}


def _models(seed):
    """JAX's MiniROAD and params, and the port's on the same parameters."""
    jm = JaxMiniROAD(JaxRecognitionConfig.from_dict(RAW))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, jp, MiniROAD(RecognitionConfig.from_dict(RAW)), miniroad_from_numpy(jp)


def _key(ev):
    return (ev.stream, ev.frame_index, ev.step, ev.history, ev.anticipated, ev.is_mistake)


def _drive(det, frames, block):
    """Frames through a single-stream detector, per frame or in blocks,
    and the trailing flush: the events in order."""
    events = []
    if block == 1:
        for f in frames:
            ev = det.push_frame(f)
            if ev is not None:
                events.append(ev)
    else:
        for t0 in range(0, len(frames), block):
            events.extend(det.push_frames(frames[t0 : t0 + block]))
    tail = det.finish()
    return events + ([tail] if tail is not None else [])


def test_streaming_aggregator_matches_offline(rng):
    for _ in range(5):
        preds = rng.integers(0, 6, int(rng.integers(50, 900))).tolist()
        agg, jagg = OnlineAggregator(6, window_size=200), JaxAggregator(6, window_size=200)
        for p in preds:
            assert agg.push(int(p)) == jagg.push(int(p))
        assert agg.flush() == jagg.flush()
        assert agg.sequence == jagg.sequence == aggregate_video(preds, preds)["pred"]


def test_online_recognizer_matches_jax_and_batch_eval(rng):
    jm, jp, tm, tp = _models(0)
    T = 30
    rgb = rng.normal(0, 1, (T, tm.rgb_dim)).astype(np.float32)
    rec = OnlineRecognizer(tm, tp, batch=1, flow_is_zero=True, device="cpu")
    jrec = JaxRecognizer(jm, jp, batch=1, flow_is_zero=True)
    ids = [int(rec.step(rgb[t][None])[0]) for t in range(T)]
    assert ids == [int(jrec.step(rgb[t][None])[0]) for t in range(T)]
    scores = tm.forward_full(tp, torch.from_numpy(rgb[None]), None, flow_is_zero=True)
    assert ids == scores[0].argmax(-1).tolist()
    np.testing.assert_allclose(rec.hidden[0].numpy(), np.asarray(jrec.hidden[0]),
                               rtol=1e-4, atol=1e-5)


def test_step_block_matches_per_frame(rng):
    jm, jp, tm, tp = _models(5)
    T, B = 24, 2
    frames = rng.normal(0, 1, (T, B, tm.rgb_dim)).astype(np.float32)
    rec1 = OnlineRecognizer(tm, tp, batch=B, device="cpu")
    per_frame = np.stack([rec1.step(frames[t]) for t in range(T)])
    rec2 = OnlineRecognizer(tm, tp, batch=B, device="cpu")
    blocked = np.concatenate([rec2.step_block(frames[:10]), rec2.step_block(frames[10:])])
    np.testing.assert_array_equal(per_frame, blocked)
    for h1, h2 in zip(rec1.hidden, rec2.hidden):
        assert torch.equal(h1, h2)  # the same steps in the same order
    jrec = JaxRecognizer(jm, jp, batch=B)
    np.testing.assert_array_equal(blocked, np.asarray(jrec.step_block(frames)))


def test_online_detector_matches_jax(rng):
    jm, jp, tm, tp = _models(1)
    frames = rng.normal(0, 1, (45, tm.rgb_dim)).astype(np.float32)
    kw = dict(context="", toy="t1", type_prompt="num", window_size=10, temperature=0.0)
    det = OnlineMistakeDetector(OnlineRecognizer(tm, tp, device="cpu"), FakeLLM(), **kw)
    jdet = JaxDetector(JaxRecognizer(jm, jp), JaxFakeLLM(), **kw)
    events = _drive(det, frames, 1)
    assert 1 <= len(events) <= 5  # 4 full windows + the flush, on extension only
    assert [_key(e) for e in events] == [_key(e) for e in _drive(jdet, frames, 1)]
    for ev in events:
        assert ev.step == det.aggregator.sequence[len(ev.history)]
        assert isinstance(ev.anticipated, set) and ev.anticipated


def test_push_frames_matches_push_frame(rng):
    """One device block per N frames gives the events of the per-frame
    path, also where a block splits a window; and JAX's events."""
    jm, jp, tm, tp = _models(6)
    frames = rng.normal(0, 1, (47, tm.rgb_dim)).astype(np.float32)
    kw = dict(context="", toy="t1", type_prompt="num", window_size=10, temperature=0.0)
    make = lambda: OnlineMistakeDetector(OnlineRecognizer(tm, tp, device="cpu"), FakeLLM(), **kw)
    base_det = make()
    base = [_key(e) for e in _drive(base_det, frames, 1)]
    for block in (7, 10, 47):  # window-splitting, window-aligned, whole stream
        det = make()
        assert [_key(e) for e in _drive(det, frames, block)] == base
        assert det.aggregator.sequence == base_det.aggregator.sequence
        jdet = JaxDetector(JaxRecognizer(jm, jp), JaxFakeLLM(), **kw)
        assert [_key(e) for e in _drive(jdet, frames, block)] == base
    two = OnlineMistakeDetector(OnlineRecognizer(tm, tp, batch=2, device="cpu"), FakeLLM())
    with pytest.raises(ValueError, match="SINGLE"):
        two.push_frames(frames[:3])


def test_multistream_matches_independent_detectors(rng):
    """B streams, one device block and one batched LLM call a block: the
    per-stream events of B single-stream detectors, and JAX's."""
    jm, jp, tm, tp = _models(8)
    B, T = 3, 44
    frames = rng.normal(0, 1, (T, B, tm.rgb_dim)).astype(np.float32)
    singles = []
    for b in range(B):
        det = OnlineMistakeDetector(OnlineRecognizer(tm, tp, device="cpu"), FakeLLM(),
                                    context="", toy=f"t{b}", type_prompt="num", window_size=10,
                                    temperature=0.0)
        singles.append((det, _drive(det, frames[:, b], 1)))
    kw = dict(stream_prompts=[{"context": "", "toy": f"t{b}"} for b in range(B)],
              type_prompt="num", window_size=10, temperature=0.0)
    multi = MultiStreamMistakeDetector(OnlineRecognizer(tm, tp, batch=B, device="cpu"),
                                       FakeLLM(), **kw)
    jmulti = JaxMulti(JaxRecognizer(jm, jp, batch=B), JaxFakeLLM(), **kw)
    for t0 in range(0, T, 13):  # window-splitting block boundaries
        multi.push_frames(frames[t0 : t0 + 13])
        jmulti.push_frames(frames[t0 : t0 + 13])
    multi.finish()
    jmulti.finish()
    for b, (det, evs) in enumerate(singles):
        assert multi.aggregators[b].sequence == det.aggregator.sequence
        got = multi.events[b]
        assert [_key(e)[1:] for e in got] == [_key(e)[1:] for e in evs]
        assert all(e.stream == b for e in got)
        assert [_key(e) for e in got] == [_key(e) for e in jmulti.events[b]]


def test_multistream_reset_stream(rng):
    _, _, tm, tp = _models(9)
    rec = OnlineRecognizer(tm, tp, batch=2, device="cpu")
    multi = MultiStreamMistakeDetector(rec, FakeLLM(), type_prompt="num", window_size=5,
                                       temperature=0.0)
    frames = rng.normal(0, 1, (12, 2, tm.rgb_dim)).astype(np.float32)
    multi.push_frames(frames)
    assert multi.frame_index == [12, 12]
    multi.reset_stream(0)
    assert multi.frame_index == [0, 12]
    assert multi.aggregators[0].sequence == []
    assert torch.all(rec.hidden[0][0] == 0)
    assert not torch.all(rec.hidden[0][1] == 0)
    multi.push_frames(frames[:5])  # stream 1 keeps accumulating after the reset
    assert multi.frame_index == [5, 17]


def test_recognizer_per_stream_reset(rng):
    _, _, tm, tp = _models(2)
    rec = OnlineRecognizer(tm, tp, batch=2, device="cpu")
    frames = rng.normal(0, 1, (6, 2, tm.rgb_dim)).astype(np.float32)
    for t in range(3):
        rec.step(frames[t])
    rec.reset(stream=0)  # stream 0 restarts; stream 1 keeps its state
    assert torch.all(rec.hidden[0][0] == 0)
    assert not torch.all(rec.hidden[0][1] == 0)


def test_recognizer_needs_a_card_unless_cpu(monkeypatch):
    _, _, tm, tp = _models(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        OnlineRecognizer(tm, tp)


@pytest.mark.parametrize("serving", ["batch", "cb"])
def test_multistream_with_llama_matches_jax(rng, serving):
    """The live loop with the LLaMA backend (tiny weights from JAX through
    the bridge, greedy), in batch and in cb mode: the same events as JAX's
    detector over the jax-llama adapter in the same mode."""
    jm, jp, tm, tp = _models(4)
    jllm = JaxLlamaLLM(ckpt_dir="", tokenizer_path="", fabricated="tiny", max_seq_len=256,
                       serving=serving, cb_slots=4)
    jcfg = jllm.llama.config
    tllm = TorchLlamaLLM(params=llama_from_numpy(jax.tree.map(np.asarray, jllm.llama.params)),
                         config=LlamaConfig(**{f: getattr(jcfg, f)
                                               for f in jcfg.__dataclass_fields__}),
                         device="cpu", serving=serving, cb_slots=4)
    context = "Sequence type: t1\nInput Sequence:\n -1, 2\nNext Symbol:\n 3\n---\n"
    B, T = 2, 40
    frames = rng.normal(0, 1, (T, B, tm.rgb_dim)).astype(np.float32)
    kw = dict(stream_prompts=[{"context": context, "toy": f"t{b}"} for b in range(B)],
              type_prompt="num", window_size=8, temperature=0.0, max_gen_len=3)
    multi = MultiStreamMistakeDetector(OnlineRecognizer(tm, tp, batch=B, device="cpu"),
                                       tllm, **kw)
    jmulti = JaxMulti(JaxRecognizer(jm, jp, batch=B), jllm, **kw)
    for t0 in range(0, T, 16):
        multi.push_frames(frames[t0 : t0 + 16])
        jmulti.push_frames(frames[t0 : t0 + 16])
    multi.finish()
    jmulti.finish()
    assert any(multi.events), "at least one aggregated step must surface"
    for b in range(B):
        assert [_key(e) for e in multi.events[b]] == [_key(e) for e in jmulti.events[b]]
    if serving == "cb":
        assert tllm._cb is not None and tllm.llama.decode_steps == 0  # all through the slots
