"""The port's core/profiling.py: ``annotate`` gated on a recording
profiler, the trace file with its annotation, and the device-time helpers
on synthetic spans."""

import glob
import json
from types import SimpleNamespace

import torch

from prego_tpu_torch.core import profiling


def test_annotate_is_a_null_context_without_a_profiler(monkeypatch):
    """No profiler recording: the shared null context, and no
    record_function built."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.annotate("prego.x") is profiling.NO_SPAN
    with profiling.annotate("prego.x"), profiling.annotate("prego.y"):  # reusable, nestable
        pass


def test_annotate_records_a_range_under_a_profiler(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        span = profiling.annotate("prego.x")
        with span:
            torch.ones(8) + 1
    assert span is not profiling.NO_SPAN
    assert [e.name for e in prof.events() if e.name.startswith("prego.")] == ["prego.x"]


def test_trace_writes_the_annotation(tmp_path):
    """A trace of the CPU build (no card, no nvtx) holds the annotated range."""
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("decode_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "decode_step" for e in events)
    assert any(e.key == "decode_step" for e in prof.key_averages())
    assert profiling.busy_us(prof) is None  # no device activity recorded


def _prof(spans):
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(name=n, device_type=cuda if dev else cpu,
                              time_range=SimpleNamespace(start=s, end=e))
              for n, s, e, dev in spans]
    return SimpleNamespace(events=lambda: events)


def test_busy_us_counts_overlapping_spans_once():
    """A programmatic dependent launched beside its prerequisite: the time
    they share counts once; host events are not the device's."""
    prof = _prof([("pass1", 0.0, 10.0, True), ("projection", 6.0, 14.0, True),
                  ("gap_kernel", 20.0, 25.0, True), ("host op", 0.0, 100.0, False)])
    assert profiling.busy_us(prof) == 19.0
    assert [n for n, _, _ in profiling.device_spans(prof)] == ["pass1", "projection",
                                                               "gap_kernel"]
    assert profiling.span_union([(6, 14), (0, 10), (14, 15), (20, 25)]) == [[0, 15], [20, 25]]


def test_new_modules_and_chip_smoke_import_no_jax():
    """In a fresh interpreter: core/profiling.py, parallel/ and
    chip_smoke.py (which imports the device-time helpers) load neither jax
    nor the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, json\n"
        "import prego_tpu_torch.core.profiling, prego_tpu_torch.parallel.sp\n"
        "import prego_tpu_torch.parallel, chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'prego_tpu' or m.startswith('prego_tpu.'))))\n")
    env = {**os.environ, "PYTHONPATH": str(repo) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(repo), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
