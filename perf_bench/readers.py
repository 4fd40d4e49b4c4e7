"""Arithmetic that several per-layer metric readers share. Each reader in
``metrics/`` takes the loop of a traced run and returns a number, or
None where the trace holds nothing to read."""

from __future__ import annotations

from typing import List, Optional, Tuple

from perf_bench import yardstick

# kernel names in the device trace (prego_tpu_torch/csrc)
K1 = ("gru_recurrence_kernel",)
K2 = ("decode_cluster_kernel",)
K6 = ("gru_bwd_kernel",)
K7A = ("ffn_up_kernel", "ffn_down_kernel", "ffn_reduce_kernel")


def device_idle(loop) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device."""
    tr = loop.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(loop, flops: float) -> Optional[float]:
    """Model FLOPs over the traced window against the bf16 dense peak."""
    tr = loop.trace
    if tr is None or not tr.device or flops <= 0:
        return None
    return yardstick.share(flops / tr.window_s, yardstick.PEAK_BF16_FLOPS)


def roofline(bounds: List[float], spans: List[Tuple[float, float]]) -> Optional[float]:
    """The sum of the launches' bounds over the kernels' device time (the
    union of their spans)."""
    busy = yardstick.union_length(spans)
    if not spans or busy <= 0:
        return None
    return yardstick.share(sum(bounds), busy)


def per_call_kernels(loop, names) -> List[Tuple[object, List[Tuple[str, float, float]]]]:
    """(call, its kernels of ``names`` in start order) for each traced
    call: a call's kernels start inside its host span, since each call
    ends in a read of the device."""
    tr = loop.trace
    if tr is None:
        return []
    ks = sorted(tr.kernels(*names), key=lambda k: k[1])
    out = []
    for (s, e), call in zip(tr.in_span("call"), loop.traced_calls):
        out.append((call, [k for k in ks if s <= k[1] <= e]))
    return out
