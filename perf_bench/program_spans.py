"""Arithmetic over the program's own spans that the per-layer readers of the
generation and online-serving layers share.

The port names its spans ``prego.<layer>.<phase>`` (``core/profiling.
annotate``, recorded only under a profiler). A reader takes them by full
name from the main thread of the traced window's host operations
(``Trace.host``: the thread with the most of them, as ``Trace.breakdown``
takes it). Each function returns None where the trace holds no such span,
as for a program that records none.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Tuple

from perf_bench import yardstick

TAIL_STEP = "prego.generate.tail_step"  # a decode step that feeds some row's prompt token
STEP = "prego.generate.step"  # every other decode step
DECODE = (TAIL_STEP, STEP)
RECOGNIZE = "prego.online.recognize"  # a block's recognizer work and its host read


def spans(trace, *names: str) -> List[Tuple[float, float]]:
    """(start, end) of the main thread's host spans named any of ``names``,
    in start order."""
    if trace is None or not trace.host:
        return []
    threads = Counter(h[3] for h in trace.host)
    main = max(threads, key=threads.get)
    return sorted((s, e) for n, s, e, t in trace.host if t == main and n in names)


def _length(sp: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in sp)


def overlap(a: Sequence[Sequence[float]], b: Sequence[Sequence[float]]) -> float:
    """The length of the intersection of two unions of intervals (each
    sorted and disjoint, as ``yardstick.span_union`` gives them)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def share_of(trace, part: Sequence[str], whole: Sequence[str]) -> Optional[float]:
    """Host time in the spans named ``part`` over that in those named
    ``whole``, %."""
    den = _length(spans(trace, *whole))
    if den <= 0:
        return None
    return 100.0 * _length(spans(trace, *part)) / den


def mean_ms(trace, *names: str) -> Optional[float]:
    """The mean length of the spans named ``names``, ms."""
    sp = spans(trace, *names)
    if not sp:
        return None
    return 1000.0 * _length(sp) / len(sp)


def idle_share(trace, *names: str) -> Optional[float]:
    """The part of the union of the spans named ``names`` in which nothing
    ran on the device, over that union, %. None where the trace holds no
    such span or no device activity."""
    union = yardstick.span_union(spans(trace, *names))
    total = _length(union)
    if total <= 0 or not trace.device:
        return None
    busy = overlap(union, yardstick.span_union((s, e) for _, s, e in trace.device))
    return 100.0 * (1.0 - busy / total)
