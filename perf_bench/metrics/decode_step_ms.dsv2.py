"""The mean host length of a decode step (a `prego.generate.step` span) in
the traced calls of DeepSeek-V2, ms (moves checks_per_s)."""

from perf_bench import program_spans as ps


def read(loop):
    return ps.mean_ms(loop.trace, ps.STEP)
