"""The share of the traced blocks in which the device ran nothing (moves
online_frames_per_s)."""

from perf_bench.readers import device_idle as read  # noqa: F401
