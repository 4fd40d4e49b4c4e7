"""K7 (the decode FFN, csrc/fused_ffn_bf16.cu: `moe_counts.K7`), which
runs DeepSeek-V2's shared experts at decode, against its bound in the
traced calls: for each decode step and MoE layer, the shared experts' w13
and w2 read once and the call's rows in and out, however many launches the
rows are split into (moves checks_per_s)."""

from perf_bench import moe_counts


def read(loop):
    c = loop.c
    return moe_counts.ffn_roofline(loop, moe_counts.K7, c["n_shared_experts"]
                                   * c["moe_intermediate_size"], moe_counts.n_moe_layers(c))
