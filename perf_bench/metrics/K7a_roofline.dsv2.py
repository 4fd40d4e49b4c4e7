"""K7a (the decode FFN sub-layer, csrc/fused_ffn.cu: ffn_up, ffn_down,
ffn_reduce), which runs DeepSeek-V2's dense first layers at decode, against
its bound in the traced calls: for each decode step and dense layer, w13
and w2 read once and the call's rows in and out, however many launches the
rows are split into (moves checks_per_s)."""

from perf_bench import moe_counts, readers


def read(loop):
    c = loop.c
    return moe_counts.ffn_roofline(loop, readers.K7A, c["ffn_hidden"],
                                   c["n_layers"] - moe_counts.n_moe_layers(c))
