"""Device milliseconds of the routed experts' grouped GEMMs
(`moe_counts.GROUPED_MM`) a traced call: the union of their device spans
in the traced calls over the number of those calls (moves checks_per_s)."""

from perf_bench import moe_counts, readers, yardstick


def read(loop):
    per_call = readers.per_call_kernels(loop, moe_counts.GROUPED_MM)
    spans = [(k[1], k[2]) for _, ks in per_call for k in ks]
    if not spans:
        return None
    return 1000.0 * yardstick.union_length(spans) / len(per_call)
