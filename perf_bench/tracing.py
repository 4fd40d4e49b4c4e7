"""The traced part of a window: torch.profiler over the host and the card,
reduced to device spans by name, the harness's own host spans, and the
breakdown the result line carries.

A traced run starts the profiler at a boundary of the window's work and
stops it a few units later (``trace_units`` in the traffic file), both
after a synchronize, so that the traced window is whole units of work.
``window_s`` is the host clock between the two; ``busy_s`` the union of
the device's activity in the trace.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from perf_bench import yardstick

SPAN_PREFIX = "perf_bench."  # the names of the harness's own host spans


@dataclass
class Trace:
    """What a traced window saw. Times are seconds from the trace's start."""

    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end
    host: List[Tuple[str, float, float, int]] = field(default_factory=list)  # + thread
    # the harness's spans are host operations too, under their full names
    spans: List[Tuple[str, float, float]] = field(default_factory=list)  # the harness's

    @property
    def busy_s(self) -> float:
        return yardstick.union_length((s, e) for _, s, e in self.device)

    def kernels(self, *names: str) -> List[Tuple[str, float, float]]:
        """Device spans whose name contains any of ``names``."""
        return [d for d in self.device if any(n in d[0] for n in names)]

    def in_span(self, span_name: str) -> List[Tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == span_name]

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        time by what the host was doing: the innermost host operation of
        the main thread that covers a gap's midpoint."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            ops[n[:120]] += e - s
        gaps = yardstick.idle_gaps([(s, e) for _, s, e in self.device], 0.0, self.window_s)
        by_host: Dict[str, float] = defaultdict(float)
        threads: Dict[int, int] = defaultdict(int)
        for h in self.host:
            threads[h[3]] += 1
        main = max(threads, key=threads.get) if threads else None
        host = sorted((s, e, n) for n, s, e, t in self.host if t == main)
        starts = [h[0] for h in host]
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            i = bisect.bisect_right(starts, mid)
            name = "no host operation"
            # the innermost (latest-starting) host operation that covers mid
            for j in range(i - 1, max(-1, i - 400), -1):
                s, e, n = host[j]
                if e >= mid:
                    name = n
                    break
            by_host[name[:120]] += ge - gs
        top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in top_ops],
                "idle_gaps": [[n, s] for n, s in top_gaps]}


class Tracer:
    """Starts and stops torch.profiler on the CPU and the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.trace: Optional[Trace] = None
        self._done = None
        self._t0 = self._window_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Stops tracing; the trace is reduced later, outside the window."""
        self._sync()
        self._window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self._done, self.prof = self.prof, None

    def result(self) -> Optional[Trace]:
        """The trace of the traced window (reduced on first use)."""
        if self.trace is None and self._done is not None:
            self.trace = _reduce(self._done, self._window_s)
            self._done = None
        return self.trace

    @property
    def active(self) -> bool:
        return self.prof is not None


def span(name: str):
    """A host span of the harness, seen in the trace as ``perf_bench.<name>``."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _reduce(prof, window_s: float) -> Trace:
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    rows = [(e.name(), e.start_ns(), e.end_ns(), e.device_type(), e.start_thread_id())
            for e in events]
    trace = Trace(window_s=window_s)
    host = [r for r in rows if r[3] == cpu]
    if not host:
        return trace
    # a user annotation (record_function) shows on the device too, as the
    # span of the kernels launched inside it: not device activity
    annotations = {e.name() for e in events if e.device_type() == cpu and e.is_user_annotation()}
    t0 = min(r[1] for r in host)
    for name, s, e, dev, thread in rows:
        s, e = (s - t0) * 1e-9, (e - t0) * 1e-9
        if dev == cpu:
            if name.startswith(SPAN_PREFIX):
                trace.spans.append((name[len(SPAN_PREFIX):], s, e))
            trace.host.append((name, s, e, thread))
        elif name not in annotations:
            trace.device.append((name, s, e))
    return trace
