"""Tracing and profiling utilities (port of prego_tpu/core/profiling.py).

The reference has only wall-clock FPS logging (SURVEY.md §5). Here:
  * ``trace(logdir)``: a context manager around ``torch.profiler.profile``
    that records the host, and the card where one is in use, and writes a
    Chrome / TensorBoard trace (``*.pt.trace.json``) into ``logdir`` on
    exit; no tensorboard package is needed to write it;
  * ``annotate(name)``: a ``torch.profiler.record_function`` range, which
    the trace shows by name (the CPU build has it too);
  * ``ThroughputMeter``: steady-state items/sec with warm-up intervals
    dropped and a device-sync callback (callers on the card pass
    ``torch.cuda.synchronize``: a CUDA launch returns before the work);
  * ``device_spans`` / ``span_union`` / ``busy_us``: the device's activity
    in a profiler session, and its time as the union of those spans (a
    kernel launched as another's programmatic dependent runs beside it,
    and the time they share counts once).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its trace into ``logdir`` on exit: the
    host's activity, and the card's where one is visible. Yields the
    ``torch.profiler.profile`` object (its ``events()`` and
    ``key_averages()`` are there after the block)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(
        activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def annotate(name: str):
    """A named range in the trace (a context manager)."""
    return torch.profiler.record_function(name)


@dataclass
class ThroughputMeter:
    """Accumulates (items, seconds) intervals; warmup intervals discarded."""

    warmup: int = 1
    sync: Optional[Callable[[], None]] = None
    _intervals: List = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        if self.sync is not None:
            self.sync()
        self._t0 = time.perf_counter()

    def stop(self, items: int):
        if self.sync is not None:
            self.sync()
        assert self._t0 is not None, "stop() without start()"
        self._intervals.append((items, time.perf_counter() - self._t0))
        self._t0 = None

    @property
    def items_per_sec(self) -> float:
        kept = self._intervals[self.warmup :] or self._intervals
        items = sum(i for i, _ in kept)
        secs = sum(s for _, s in kept)
        return items / secs if secs > 0 else 0.0

    @property
    def intervals(self) -> List:
        return list(self._intervals)


def device_spans(prof) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device activity a profiler session
    recorded: kernels, copies, sets."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def span_union(spans: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """(start, end) intervals merged where they overlap or touch, in order."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(prof) -> Optional[float]:
    """The union of the device's activity intervals in a profiler session,
    us: kernels that overlap count once. None where the session saw no
    device activity."""
    spans = sorted((s, e) for _, s, e in device_spans(prof))
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy if spans else None
