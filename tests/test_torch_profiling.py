"""The port's core/profiling.py against prego_tpu/core/profiling.py: the
throughput meter fed the same clock, the trace file with its annotation,
and the device-time helpers on synthetic spans."""

import glob
import json
import time
from types import SimpleNamespace

import pytest
import torch

from prego_tpu_torch.core import profiling


class _Clock:
    """time.perf_counter stand-in: each call returns the next reading."""

    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self):
        return self.readings.pop(0)


@pytest.mark.parametrize("warmup,spans", [(1, [(4, 0.5), (8, 1.0), (8, 3.0)]),
                                          (5, [(4, 0.5), (6, 1.5)]),
                                          (0, [(3, 0.0)])])
def test_throughput_meter_matches_jax(monkeypatch, warmup, spans):
    """The same intervals through both meters: warm-up intervals dropped,
    all of them kept where every interval is warm-up, 0 for no time."""
    from prego_tpu.core.profiling import ThroughputMeter as JaxMeter

    readings = [x for _, s in spans for x in (10.0, 10.0 + s)]
    results = []
    for cls in (JaxMeter, profiling.ThroughputMeter):
        synced = []
        monkeypatch.setattr(time, "perf_counter", _Clock(readings))
        meter = cls(warmup=warmup, sync=lambda: synced.append(1))
        for items, _ in spans:
            meter.start()
            meter.stop(items)
        results.append((meter.items_per_sec, meter.intervals, len(synced)))
    assert results[0] == results[1]
    assert results[1][2] == 2 * len(spans)  # a sync at every start and stop


def test_throughput_meter_stop_without_start():
    with pytest.raises(AssertionError, match="without start"):
        profiling.ThroughputMeter().stop(1)


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
