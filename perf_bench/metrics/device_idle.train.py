"""The share of the traced training steps in which the device ran nothing
(moves train_windows_per_s)."""

from perf_bench.readers import device_idle as read  # noqa: F401
