"""The routed experts' grouped GEMMs (`torch._grouped_mm`'s kernels, by the
names in `moe_counts.GROUPED_MM`) against their bound in the traced calls:
for each MoE layer-forward of a call, from the port's counters of that
call (rows a forward, layer and expert), the larger of 2 rows 3 D F over
the bf16 peak and (the experts hit x 3 D F + the rows in and out) bf16
bytes over the memory's bandwidth (moves checks_per_s)."""

from perf_bench import moe_counts, readers


def read(loop):
    bounds, spans = [], []
    for call, ks in readers.per_call_kernels(loop, moe_counts.GROUPED_MM):
        counts = getattr(call, "moe", None)
        if counts is None or not ks:
            continue
        for rows in counts.reshape(-1, counts.shape[-1]):
            bounds.append(moe_counts.routed_bound_s(loop.c, int(rows.sum()), int((rows > 0).sum())))
        spans.extend((k[1], k[2]) for k in ks)
    return readers.roofline(bounds, spans)
