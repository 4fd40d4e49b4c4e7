"""The part of the traced calls' decode steps (the union of their
`prego.generate` decode spans) in which nothing ran on the device, over
that union, for DeepSeek-V2 (moves checks_per_s)."""

from perf_bench import program_spans as ps


def read(loop):
    return ps.idle_share(loop.trace, *ps.DECODE)
