"""Host time in the decode steps that feed some row's own prompt token
(`prego.generate.tail_step`) over the time in all decode steps
(`tail_step` and `step`) of the traced calls (moves checks_per_s)."""

from perf_bench import program_spans as ps


def read(loop):
    return ps.share_of(loop.trace, [ps.TAIL_STEP], ps.DECODE)
