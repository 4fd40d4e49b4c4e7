"""K2 (decode attention, csrc/decode_attention.cu) against its bound in the
traced calls: the live K and V of each decode step read once. The j-th K2
launch of a call is decode step j // n_layers, whose rows attend to the
call's shortest prompt plus j // n_layers + 1 positions (moves
checks_per_s)."""

from perf_bench import readers, yardstick


def read(loop):
    L = loop.c["n_layers"]
    bounds, spans = [], []
    for call, ks in readers.per_call_kernels(loop, readers.K2):
        first = min(len(p) for p in loop.prompt_ids(call))
        for j, k in enumerate(ks):
            keys = first + j // L + 1
            bounds.append(yardstick.bound_s(*yardstick.k2_launch(loop.c, call.rows, keys)))
            spans.append((k[1], k[2]))
    return readers.roofline(bounds, spans)
