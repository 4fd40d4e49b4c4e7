"""Model FLOPs of the traced calls over the traced window, against the bf16
dense peak: each call's common prompt prefix once, every check's suffix and
its served tokens (moves checks_per_s)."""

from perf_bench import readers


def read(loop):
    return readers.mfu(loop, sum(loop.call_flops(c) for c in loop.traced_calls))
