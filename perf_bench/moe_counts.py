"""The operations and bytes of DeepSeek-V2 (multi-head latent attention and
DeepSeekMoE), which the per-layer readers of its cells use.

``c`` is the configuration file's ``llm`` block merged with its
``deepseek_v2`` block. A model FLOP counts what a token's pass needs,
whatever form computes it: two a multiply-add of every weight the token
touches (its attention projections, its top-k routed experts, the shared
experts, the dense FFN of the first layers, the router), plus q.k at
qk_nope + qk_rope and p.v at v_head_dim over each key it attends to, plus
the lm-head of each row that is sampled.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from perf_bench import program_spans as ps
from perf_bench import readers, yardstick

# the routed experts' grouped GEMMs (torch._grouped_mm, CUTLASS's grouped
# kernels) as the device trace names them
GROUPED_MM = ("GroupProblemShape", "grouped_gemm", "GroupedGemm")
# K7, the decode FFN that runs the shared experts (csrc/fused_ffn_bf16.cu's
# ffn_kernel<M>); K7a, the first layers' dense FFN at decode, is
# readers.K7A (csrc/fused_ffn.cu)
K7 = ("::ffn_kernel<",)


def is_moe_layer(c: Dict, i: int) -> bool:
    return i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0


def n_moe_layers(c: Dict) -> int:
    return sum(is_moe_layer(c, i) for i in range(c["n_layers"]))


def active_params(c: Dict) -> int:
    """Weights one token's pass through the layers multiplies (no lm-head)."""
    D, H = c["dim"], c["n_heads"]
    dn, dr, dv, R = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"]
    E, k, F = c["n_routed_experts"], c["num_experts_per_tok"], c["moe_intermediate_size"]
    Fs = c["n_shared_experts"] * F
    attn = D * (H * (dn + dr) + dr + R) + R * H * (dn + dv) + H * dv * D
    dense = 3 * D * c["ffn_hidden"]
    routed = D * E + k * 3 * D * F + 3 * D * Fs
    return sum(attn + (routed if is_moe_layer(c, i) else dense) for i in range(c["n_layers"]))


def flops(c: Dict, positions: Sequence[int], head_rows: int) -> float:
    """FLOPs of running tokens at the given absolute positions through the
    layers (each attends to its position + 1 keys), plus ``head_rows`` rows
    of the lm-head."""
    per_key = 2 * c["n_layers"] * c["n_heads"] * (
        c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"])
    keys = sum(p + 1 for p in positions)
    return (2 * active_params(c) * len(positions) + per_key * keys
            + 2 * head_rows * c["dim"] * c["vocab_size"])


def call_flops(c: Dict, prompts: Sequence[Sequence[int]], served: Sequence[int]) -> float:
    """The model FLOPs one completion call's inputs need: the common prefix
    of its prompts once, each prompt's suffix after it, and each served
    token but the last through the layers; one lm-head row a served token
    (``yardstick.llama_call_flops``'s tokens)."""
    common = min(len(p) for p in prompts)
    first = prompts[0]
    shared = 0
    while shared < common and all(p[shared] == first[shared] for p in prompts):
        shared += 1
    shared = min(shared, common - 1)  # the last prompt token gives the first logits
    positions = list(range(shared))
    heads = 0
    for p, n in zip(prompts, served):
        positions.extend(range(shared, len(p) + max(n - 1, 0)))
        heads += n
    return flops(c, positions, heads)


def routed_launch(c: Dict, rows: int, hits: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one MoE layer-forward's routed experts (the w13 and
    w2 grouped GEMMs together) over ``rows`` token-expert rows that fall on
    ``hits`` experts: each expert hit read once, the rows in and out."""
    D, F = c["dim"], c["moe_intermediate_size"]
    flops_ = 2 * rows * 3 * D * F
    nbytes = yardstick.BF16 * (hits * 3 * D * F + 2 * rows * D)
    return flops_, nbytes


def routed_bound_s(c: Dict, rows: int, hits: int) -> float:
    return yardstick.bound_s(*routed_launch(c, rows, hits))


def ffn_launch(c: Dict, width: int, rows: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's decode FFN of hidden ``width`` over
    ``rows`` tokens: w13 and w2 read once, the rows in and out, however many
    launches the rows are split into."""
    D = c["dim"]
    return 2 * rows * 3 * D * width, yardstick.BF16 * (3 * D * width + 2 * rows * D)


def per_call_decode_kernels(loop, names) -> List[Tuple[object, List, int]]:
    """(call, its kernels of ``names``, its decode steps) for each traced
    call: the steps are the ``prego.generate`` decode spans that start
    inside the call's span."""
    steps = [s for s, _ in ps.spans(loop.trace, *ps.DECODE)]
    calls = loop.trace.in_span("call") if loop.trace is not None else []
    return [(call, ks, sum(1 for t in steps if s <= t <= e))
            for (s, e), (call, ks) in zip(calls, readers.per_call_kernels(loop, names))]


def ffn_roofline(loop, names, width: int, layers: int) -> Optional[float]:
    """A decode FFN's kernels (``names``) against their bound in the traced
    calls: one ``ffn_launch`` of the call's rows a decode step and layer."""
    bounds, spans = [], []
    for call, ks, steps in per_call_decode_kernels(loop, names):
        if not ks:
            continue
        bound = yardstick.bound_s(*ffn_launch(loop.c, width, call.rows))
        bounds.extend([bound] * (steps * layers))
        spans.extend((k[1], k[2]) for k in ks)
    return readers.roofline(bounds, spans)
