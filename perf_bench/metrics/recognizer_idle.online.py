"""The part of the traced blocks' recognizer work (the union of their
`prego.online.recognize` spans: the frames in, the per-frame steps and the
vote, the host's read) in which nothing ran on the device, over that union
(moves online_frames_per_s)."""

from perf_bench import program_spans as ps


def read(loop):
    return ps.idle_share(loop.trace, ps.RECOGNIZE)
