"""Model FLOPs of the traced calls over the traced window, against the bf16
dense peak, for DeepSeek-V2 (``moe_counts.call_flops``: the weights each
token touches, its top-k routed and the shared experts among them, q.k and
p.v over its keys, and the lm-head of each served token), whatever form
computes them (moves checks_per_s)."""

from perf_bench import readers


def read(loop):
    return readers.mfu(loop, sum(loop.call_flops(c) for c in loop.traced_calls))
