"""Device milliseconds of host-to-device copies a traced training step: the
native engine's pinned batches (moves train_windows_per_s)."""


def read(loop):
    if loop.trace is None or loop.steps_in_trace() == 0:
        return None
    copies = [e - s for n, s, e in loop.trace.device if "HtoD" in n]
    if not copies:
        return None
    return 1000.0 * sum(copies) / loop.steps_in_trace()
