"""The readers of the program's own spans: on synthetic traces worked out by
hand, on a trace without them (a program that records none), and on
whole tiny traced runs of both cells on the CPU."""

from __future__ import annotations

import pytest
import torch

from conftest import ROOT
from perf_bench import program_spans as ps
from perf_bench import spec, tracing
from perf_bench.spec import Bench

NEW = ["prompt_tail_share.checks", "decode_step_ms.checks", "decode_idle.checks",
       "prompt_tail_share.online", "decode_step_ms.online", "decode_idle.online",
       "recognizer_idle.online"]


def _read(name, trace):
    return Bench(ROOT).metric_reader(name)(type("L", (), {"trace": trace})())


def _trace(host, device=(), window_s=1.0):
    return tracing.Trace(window_s=window_s, device=list(device), host=list(host))


# main thread 1: two tail steps of 10 ms, one step of 20 ms; thread 2 holds
# a longer step span that is not the program's main thread
HOST = [(ps.TAIL_STEP, 0.00, 0.01, 1), (ps.TAIL_STEP, 0.01, 0.02, 1),
        (ps.STEP, 0.02, 0.04, 1), ("aten::mm", 0.0, 0.001, 1), ("aten::add", 0.0, 0.001, 1),
        (ps.STEP, 0.0, 0.5, 2)]


def test_decode_readers_by_hand():
    tr = _trace(HOST)
    for cell in ("checks", "online"):
        assert _read(f"prompt_tail_share.{cell}", tr) == pytest.approx(50.0)
        assert _read(f"decode_step_ms.{cell}", tr) == pytest.approx(40.0 / 3)


def test_idle_inside_a_span_counts_only_the_part_the_device_left_empty():
    # the decode steps cover [0, 0.04]; the device runs [0.005, 0.015] and
    # [0.03, 0.1]: 0.02 of the 0.04 busy; what it runs after 0.04 is not counted
    tr = _trace(HOST, device=[("k", 0.005, 0.015), ("k", 0.03, 0.1), ("k", 0.2, 0.3)])
    for cell in ("checks", "online"):
        assert _read(f"decode_idle.{cell}", tr) == pytest.approx(50.0)
    rec = _trace([(ps.RECOGNIZE, 0.0, 1.0, 7), (ps.RECOGNIZE, 2.0, 3.0, 7)],
                 device=[("gemm", 0.1, 0.2), ("gemm", 0.15, 0.25), ("gemm", 1.5, 2.1)])
    assert _read("recognizer_idle.online", rec) == pytest.approx(100.0 * (1 - 0.25 / 2.0))


def test_overlap_of_two_unions():
    assert ps.overlap([[0, 2], [3, 5]], [[1, 4]]) == pytest.approx(2.0)
    assert ps.overlap([[0, 1]], [[1, 2]]) == 0.0
    assert ps.overlap([], [[0, 1]]) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_the_programs_spans_reads_nothing(name):
    """The parent program records no span: every new reader gives None, and
    none raises, with or without device activity or a trace."""
    bare = _trace([("aten::mm", 0.0, 0.5, 1)], device=[("k", 0.0, 0.2)])
    assert _read(name, bare) is None
    assert _read(name, _trace([])) is None
    assert _read(name, None) is None


class CountingTracer(tracing.Tracer):
    """The harness's tracer, with the port's decode-step counter read where
    tracing starts and stops."""

    def __init__(self, device, llama_of):
        super().__init__(device)
        self.llama_of = llama_of
        self.steps = None

    def start(self):
        self._steps0 = self.llama_of().decode_steps
        super().start()

    def stop(self):
        super().stop()
        self.steps = self.llama_of().decode_steps - self._steps0


def _traced_window(tiny_bench, name, llama_of, seconds=1.0):
    cell = tiny_bench.cell(name)
    loop = spec.loop(cell.traffic["loop"]).Loop(cell, 5, torch.device("cpu"))
    loop.setup()
    tracer = CountingTracer(torch.device("cpu"), lambda: llama_of(loop))
    loop.window(seconds, tracer)
    loop.trace = tracer.result()
    return loop, tracer


@pytest.mark.parametrize("name, llama_of", [
    ("anticipate-mistral7b", lambda loop: loop.llm.llama),
    ("online-mistral7b", lambda loop: loop.llm.llm.llama),
])
def test_a_tiny_traced_run_reads_every_decode_metric(tiny_bench, name, llama_of):
    """The decode-step spans of the traced units number the increase in the
    port's ``decode_steps`` over them; the shares and lengths read numbers
    (the idle shares need a device, and read nothing on the CPU)."""
    loop, tracer = _traced_window(tiny_bench, name, llama_of)
    try:
        assert tracer.steps and len(ps.spans(loop.trace, *ps.DECODE)) == tracer.steps
        metrics = {m["name"]: tiny_bench.metric_reader(m["name"])(loop)
                   for m in tiny_bench.cell(name).per_layer if m["name"] in NEW}
        cell = name.split("-")[0].replace("anticipate", "checks")
        assert 0.0 <= metrics[f"prompt_tail_share.{cell}"] <= 100.0
        assert metrics[f"decode_step_ms.{cell}"] > 0.0
        assert metrics[f"decode_idle.{cell}"] is None
    finally:
        loop.release()
        loop.close()


def test_the_anticipate_span_holds_the_harness_llm_span(tiny_bench):
    """Each completion call of a traced tiny online run: the harness's
    ``perf_bench.llm`` span lies inside the program's
    ``prego.online.anticipate`` span, shorter by less than 1 ms; one
    ``prego.online.recognize`` span a traced block."""
    loop, _ = _traced_window(tiny_bench, "online-mistral7b", lambda loop: loop.llm.llm.llama)
    try:
        outer = ps.spans(loop.trace, "prego.online.anticipate")
        inner = ps.spans(loop.trace, tracing.SPAN_PREFIX + "llm")
        assert outer and len(outer) == len(inner)
        for (os_, oe), (is_, ie) in zip(outer, inner):
            assert os_ <= is_ and ie <= oe
            assert (oe - os_) - (ie - is_) < 1e-3
        assert len(ps.spans(loop.trace, ps.RECOGNIZE)) == len(loop.traced_calls)
    finally:
        loop.release()
        loop.close()
