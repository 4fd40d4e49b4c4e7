"""Tracing and profiling utilities (port of prego_tpu/core/profiling.py).

The reference has only wall-clock FPS logging (SURVEY.md §5). Here:
  * ``trace(logdir)``: a context manager around ``torch.profiler.profile``
    that records the host, and the card where one is in use, and writes a
    Chrome / TensorBoard trace (``*.pt.trace.json``) into ``logdir`` on
    exit; no tensorboard package is needed to write it;
  * ``annotate(name)``: the port's one span helper, a
    ``torch.profiler.record_function`` range while a profiler records and
    a shared null context otherwise (one flag check, ~0.1-0.2 us of an
    x86 host's time, where an ungated range costs ~14-17 us). The
    program's spans are named ``prego.<layer>.<phase>`` and go through the
    profiler alone, so they carry the clock of the device activity in the
    same trace;
  * ``device_spans`` / ``span_union`` / ``busy_us``: the device's activity
    in a profiler session, and its time as the union of those spans (a
    kernel launched as another's programmatic dependent runs beside it,
    and the time they share counts once).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterable, List, Optional, Tuple

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


NO_SPAN = contextlib.nullcontext()  # reusable: what ``annotate`` gives with no profiler


def annotate(name: str):
    """A named range in the trace while a profiler records, else
    ``NO_SPAN`` (a context manager either way). Open one a call, phase or
    decode step, never one a layer, kernel or frame."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN


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
