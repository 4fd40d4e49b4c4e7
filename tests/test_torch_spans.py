"""The port's spans and counters on the generation and online-serving paths,
on a tiny CPU model: the ``prego.generate.*`` spans in order, one a phase
or decode step, their counts against the host counters; the
``prego.online.*`` spans once a block; none of them built with no profiler
recording; the detectors' ``last_ids``; and ``ServeStats`` summed over
``serve_prompts`` calls."""

import dataclasses

import numpy as np
import pytest
import torch

from prego_tpu_torch.anticipation import FakeLLM
from prego_tpu_torch.core import RecognitionConfig, profiling
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, tiny_test_config
from prego_tpu_torch.models.llama.model import fuse_projections, init_params
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.serving import (
    MultiStreamMistakeDetector,
    OnlineMistakeDetector,
    OnlineRecognizer,
)
from prego_tpu_torch.serving_llm import ContinuousBatcher, ServeStats

PREFIX, PREFILL = "prego.generate.prefix", "prego.generate.prefill"
TAIL, STEP, READBACK = "prego.generate.tail_step", "prego.generate.step", "prego.generate.readback"
CAPTURE = "prego.generate.capture"
RECOGNIZE, ANTICIPATE = "prego.online.recognize", "prego.online.anticipate"
RAW = {"rgb_type": "rgb_kinetics_bninception", "flow_type": "flow_anet_resnet50",
       "embedding_dim": 32, "hidden_dim": 16, "num_layers": 1, "num_classes": 5,
       "dropout": 0.0}


@pytest.fixture(scope="module")
def params():
    cfg = dataclasses.replace(tiny_test_config(vocab_size=258), max_seq_len=256)
    gen = torch.Generator().manual_seed(3)
    return cfg, fuse_projections(init_params(cfg, gen, dtype=torch.float32))


def _llama(params):
    cfg, p = params
    return Llama(p, ByteTokenizer(), cfg)


def _prompts(shared=70, tails=(3, 9, 5)):
    """Prompts sharing ``shared`` tokens after bos, then tails of their own."""
    head = [1] + [40 + i % 50 for i in range(shared)]
    return [head + [100 + 7 * j + i for i in range(n)] for j, n in enumerate(tails)]


def _spans(prof, prefix="prego."):
    """The program's span names in start order."""
    ev = sorted((e for e in prof.events() if e.name.startswith(prefix)),
                key=lambda e: e.time_range.start)
    return [e.name for e in ev]


def _refuse_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def _run(lm, path, prompts, gen_len=6):
    if path == "prefix":
        return lm.generate_with_prefix_cache(prompts, gen_len, temperature=0.0)
    return lm.generate(prompts, gen_len, temperature=0.0)[0]


@pytest.mark.parametrize("path", ["prefix", "plain"])
def test_generate_spans_in_order_and_counted(params, tmp_path, path):
    """prefix (prefix path, on its miss), prefill, the decode steps, the
    read-back. The prompts' lengths differ, so every row decodes from its
    own prompt end: no tail step, one step span a generated token
    (``decode_steps``), the prefill counted with every row's whole suffix
    and the call with ``per_row_calls``."""
    lm = _llama(params)
    prompts = _prompts()
    eff = 64 if path == "prefix" else 0  # the cached prefix, one PREFIX_CHUNK
    lens = [len(p) - eff for p in prompts]
    before = lm.decode_steps
    with profiling.trace(str(tmp_path)) as prof:
        _run(lm, path, prompts)
    names = _spans(prof)
    head = [PREFIX, PREFILL] if path == "prefix" else [PREFILL]
    steps = lm.decode_steps - before
    assert names == head + [STEP] * steps + [READBACK]
    assert TAIL not in names and steps == 6  # max_gen_len steps
    assert lm.per_row_calls == 1
    assert lm.suffix_tokens_prefilled == sum(lens)
    assert lm.prefix_tokens_reused == len(prompts) * eff


@pytest.mark.parametrize("path", ["prefix", "plain"])
def test_cpu_call_opens_no_capture_span(params, tmp_path, path):
    """A per-row call on the CPU runs every step eagerly: no
    ``prego.generate.capture`` span, no capture and no replay counted (on
    the card a new key opens exactly one: tests/test_torch_decode_graph.py)."""
    lm = _llama(params)
    with profiling.trace(str(tmp_path)) as prof:
        _run(lm, path, _prompts())
    assert CAPTURE not in _spans(prof) and STEP in _spans(prof)
    assert lm.per_row_calls == 1
    assert (lm.decode_graph_captures, lm.decode_graph_replays) == (0, 0)


def test_prefix_span_opens_only_on_a_miss_or_an_extension(params, tmp_path):
    lm = _llama(params)
    short, longer = _prompts(shared=70), _prompts(shared=140)

    def prefix_spans(prompts):
        with profiling.trace(str(tmp_path)) as prof:
            lm.generate_with_prefix_cache(prompts, 2, temperature=0.0)
        return _spans(prof).count(PREFIX)

    assert prefix_spans(short) == 1  # a miss builds the 64-token entry
    assert prefix_spans(short) == 0  # a hit opens nothing
    assert prefix_spans(longer) == 1  # 128 tokens extend the 64-token entry
    assert (lm.prefix_rebuilds, lm.prefix_extends) == (1, 1)
    assert lm.prefix_tokens_reused == 3 * 64 + 3 * 64 + 3 * 128


@pytest.mark.parametrize("path", ["prefix", "plain"])
def test_no_profiler_no_record_function_and_the_same_tokens(params, tmp_path, monkeypatch,
                                                            path):
    prompts = _prompts()
    with profiling.trace(str(tmp_path)):
        traced = _run(_llama(params), path, prompts)
    _refuse_record_function(monkeypatch)
    assert profiling.annotate(STEP) is profiling.NO_SPAN
    lm = _llama(params)
    assert _run(lm, path, prompts) == traced
    assert (lm.decode_steps, lm.per_row_calls) == (6, 1)


@pytest.fixture(scope="module")
def miniroad():
    model = MiniROAD(RecognitionConfig.from_dict(RAW))
    return model, model.init(torch.Generator().manual_seed(11))


def _multi(miniroad, llm, B=3, window=10):
    model, tree = miniroad
    return MultiStreamMistakeDetector(
        OnlineRecognizer(model, tree, batch=B, device="cpu"), llm,
        stream_prompts=[{"context": "", "toy": f"t{b}"} for b in range(B)],
        type_prompt="num", window_size=window, temperature=0.0)


def _single(miniroad, llm, window=10):
    model, tree = miniroad
    return OnlineMistakeDetector(OnlineRecognizer(model, tree, device="cpu"), llm, context="",
                                 toy="t1", type_prompt="num", window_size=window,
                                 temperature=0.0)


@pytest.mark.parametrize("streams", [1, 3])
def test_push_frames_opens_one_recognize_and_at_most_one_anticipate_a_block(
        miniroad, tmp_path, streams):
    """Blocks no longer than a window: one ``recognize`` span a block, and
    one ``anticipate`` span for each block whose checks went to the LLM."""
    llm = FakeLLM()
    det = _multi(miniroad, llm, B=streams) if streams > 1 else _single(miniroad, llm)
    frames = np.random.default_rng(2).normal(
        0, 1, (60, streams, miniroad[0].rgb_dim)).astype(np.float32)
    if streams == 1:
        frames = frames[:, 0]
    blocks = [frames[t : t + 7] for t in range(0, 60, 7)]
    per_block = []
    for blk in blocks:
        calls = len(llm.calls)
        with profiling.trace(str(tmp_path)) as prof:
            det.push_frames(blk)
        names = _spans(prof, "prego.online.")
        per_block.append((names.count(RECOGNIZE), names.count(ANTICIPATE),
                          len(llm.calls) - calls))
        assert names[0] == RECOGNIZE
    assert all(r == 1 and a <= 1 and a == c for r, a, c in per_block)
    assert sum(a for _, a, _ in per_block) >= 1  # a window closed and was checked


def test_block_path_enters_no_record_function_without_a_profiler(miniroad, monkeypatch):
    _refuse_record_function(monkeypatch)
    rng = np.random.default_rng(4)
    multi, single = _multi(miniroad, FakeLLM()), _single(miniroad, FakeLLM())
    D = miniroad[0].rgb_dim
    for _ in range(3):
        multi.push_frames(rng.normal(0, 1, (10, 3, D)).astype(np.float32))
        single.push_frames(rng.normal(0, 1, (10, D)).astype(np.float32))
    assert any(multi.events) and single.events


@pytest.mark.parametrize("streams", [1, 3])
def test_last_ids_are_the_classes_of_step_block(miniroad, streams):
    """The detector's per-frame classes of each block, kept on the device,
    equal a recognizer's ``step_block`` over the same frames."""
    model, tree = miniroad
    det = _multi(miniroad, FakeLLM(), B=streams) if streams > 1 else _single(miniroad, FakeLLM())
    rec = OnlineRecognizer(model, tree, batch=streams, device="cpu")
    rng = np.random.default_rng(5)
    assert det.last_ids is None
    for n in (7, 13):
        frames = rng.normal(0, 1, (n, streams, model.rgb_dim)).astype(np.float32)
        det.push_frames(frames if streams > 1 else frames[:, 0])
        want = rec.step_block(frames)
        got = det.last_ids
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want if streams > 1 else want[:, 0])


def test_serve_prompts_sums_its_serve_stats(params):
    """``self.stats`` holds the ServeStats of every serve_prompts call, summed."""
    lm = _llama(params)
    cb = ContinuousBatcher(lm, slots=4, chunk=4, temperature=0.0)
    seen = []
    serve = cb.serve

    def recorded(*a, **k):
        done, st = serve(*a, **k)
        seen.append(st)
        return done, st

    cb.serve = recorded
    cb.serve_prompts(_prompts(), 4)
    cb.serve_prompts(_prompts(tails=(2, 4)), 3)
    want = ServeStats()
    for st in seen:
        want.add(st)
    assert len(seen) == 2 and cb.stats == want
    assert cb.stats.decode_steps == seen[0].decode_steps + seen[1].decode_steps > 0
    assert cb.stats.prefix_tokens_reused > 0


def test_serve_stats_add_sums_every_field():
    a = ServeStats(decode_steps=4, slot_steps_live=6, slot_steps_total=16, prefills=2,
                   prefix_hits=1, prefix_tokens_reused=64, suffix_tokens_prefilled=5,
                   suffix_tokens_piggybacked=3, wall_s=0.5)
    b = ServeStats(decode_steps=8, slot_steps_live=10, slot_steps_total=32, prefills=3,
                   prefix_hits=3, prefix_tokens_reused=128, suffix_tokens_prefilled=0,
                   suffix_tokens_piggybacked=7, wall_s=0.25)
    a.add(b)
    assert a == ServeStats(12, 16, 48, 5, 4, 192, 5, 10, 0.75)
    assert a.utilization == pytest.approx(16 / 48)
