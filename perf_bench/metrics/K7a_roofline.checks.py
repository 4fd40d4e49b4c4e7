"""K7a (the decode FFN sub-layer, csrc/fused_ffn.cu: ffn_up, ffn_down,
ffn_reduce) against its bound in the traced calls: the norm, w13 and w2
read once a launch, one launch a layer and decode step, as many as K2's
(moves checks_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    bounds, spans = [], []
    k2 = readers.per_call_kernels(loop, readers.K2)
    for (call, ks), (_, k2s) in zip(readers.per_call_kernels(loop, readers.K7A), k2):
        bound = yardstick.bound_s(*yardstick.k7a_launch(loop.c, call.rows))
        bounds.extend([bound] * len(k2s))
        spans.extend((k[1], k[2]) for k in ks)
    return readers.roofline(bounds, spans)
