"""The share of the traced window in which the device ran nothing, while
the window anticipates a collection with DeepSeek-V2 (moves checks_per_s)."""

from perf_bench.readers import device_idle as read  # noqa: F401
