"""DeepSeekMoE, DeepSeek-V2's FFN sub-layer (arXiv:2405.04434 §2.2; HF
``DeepseekV2MoE`` with ``topk_method`` greedy and ``scoring_func`` softmax):

  s = softmax(h W_gate) in f32 over all routed experts;
  the top-k of s, weighted by s_i itself (``norm_topk_prob`` false,
  ``routed_scaling_factor`` 1: no renormalisation);
  y = sum over the top k of s_i SwiGLU_i(h) + SwiGLU_shared(h),

with h = rms_norm(x, ffn_norm) and x + y the layer's output. The shared
experts are one SwiGLU of n_shared * width (``layers.feed_forward``, K7 at
decode). The weighted sum of the routed experts is f32, as in HF's
``moe_infer``.

The routed experts run as grouped products on the device: the (token,
expert) pairs sorted by expert, the offsets of each expert's rows found
by a search over the sorted ids, then w13 and w2 as one grouped GEMM each
over the experts' rows (``torch._grouped_mm`` on the card), and each
token's k weighted rows summed in its top-k order. Nothing reads
the device from the host and no Python loop runs over experts; on the CPU
``grouped_swiglu`` runs its plain version, a loop over the experts.

Counters: where ``counts`` (an (E,) int32 slot of ``Llama``'s buffer) is
given, the expert offsets of this layer-forward are copied into it, one
small copy; the host turns them into rows per expert after the call's
read-back.

Tree of a MoE layer: ``{"moe": {"gate": (D, E), "w13": (E, D, 2F),
"w2": (E, F, D), "shared": {"w13": (D, 2Fs), "w2": (Fs, D)}},
"ffn_norm": (D,)}``, each w13 the expert's [w1 | w3].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from prego_tpu_torch.models.llama.config import DeepseekV2Config
from prego_tpu_torch.models.llama.layers import feed_forward
from prego_tpu_torch.ops.dense import mm_f32
from prego_tpu_torch.ops.fused_ffn import rms_norm

Params = Dict[str, torch.Tensor]


def matrices(config: DeepseekV2Config) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of one MoE layer's matrices under its ``"moe"`` node."""
    D, E, F, Fs = (config.dim, config.n_routed_experts, config.moe_intermediate_size,
                   config.shared_hidden)
    return [(("gate",), (D, E)), (("w13",), (E, D, 2 * F)), (("w2",), (E, F, D)),
            (("shared", "w13"), (D, 2 * Fs)), (("shared", "w2"), (Fs, D))]


def route(x: torch.Tensor, gate: torch.Tensor, config: DeepseekV2Config
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (N, k) f32, experts (N, k)) of tokens x (N, D): the greedy
    top-k of the f32 softmax over all experts, not renormalised."""
    scores = torch.softmax(mm_f32(x, gate), dim=-1)
    return torch.topk(scores, config.num_experts_per_tok, dim=-1)


def grouped_swiglu_reference(xs: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                             offs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``grouped_swiglu``: a loop over the experts, each
    over its rows, rounding where the grouped products round (their outputs
    in xs' dtype)."""
    F = w2.shape[1]
    out = torch.zeros(xs.shape[0], w2.shape[2], dtype=xs.dtype, device=xs.device)
    lo = 0
    for e, hi in enumerate(offs.tolist()):
        if hi > lo:
            g = mm_f32(xs[lo:hi], w13[e]).to(xs.dtype).float()
            act = (torch.nn.functional.silu(g[:, :F]) * g[:, F:]).to(xs.dtype)
            out[lo:hi] = mm_f32(act, w2[e]).to(xs.dtype)
        lo = hi
    return out


def grouped_swiglu(xs: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """SwiGLU of each expert over its rows of ``xs`` (rows sorted by expert,
    expert e's rows ending at ``offs[e]``): (M, D) in xs' dtype. On a CUDA
    tensor two grouped GEMMs (``torch._grouped_mm``, bf16, no host read);
    on the CPU the plain loop."""
    if not xs.is_cuda:
        return grouped_swiglu_reference(xs, w13, w2, offs)
    F = w2.shape[1]
    g = torch._grouped_mm(xs, w13, offs=offs).float()
    act = (torch.nn.functional.silu(g[:, :F]) * g[:, F:]).to(xs.dtype)
    return torch._grouped_mm(act, w2, offs=offs)


_EXPERT_IDS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _expert_ids(E: int, device) -> torch.Tensor:
    key = (torch.device(device), E)
    if key not in _EXPERT_IDS:
        _EXPERT_IDS[key] = torch.arange(E, device=device)
    return _EXPERT_IDS[key]


def routed_experts(x: torch.Tensor, p: Params, config: DeepseekV2Config,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum over the top k of s_i SwiGLU_i(x) for tokens x (N, D), f32 (N, D)."""
    N, D = x.shape
    k, E = config.num_experts_per_tok, config.n_routed_experts
    w, idx = route(x, p["gate"], config)
    ids, order = torch.sort(idx.reshape(-1), stable=True)
    offs = torch.searchsorted(ids, _expert_ids(E, x.device), right=True, out_int32=True)
    if counts is not None:
        counts.copy_(offs)
    tok = order // k
    ys = grouped_swiglu(x[tok], p["w13"], p["w2"], offs)
    ys = ys.float() * w.reshape(-1)[order, None]
    # each row back to its (token, top-k) slot, the k slots summed in that
    # order: index_add_ on the card adds by atomics in no fixed order, so a
    # step would not give the same bits twice
    return ys.new_empty(N * k, D).index_copy_(0, order, ys).view(N, k, D).sum(dim=1)


def sublayer(layer: Params, h: torch.Tensor, config: DeepseekV2Config, gates,
             counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h + routed(rms_norm(h)) + shared(rms_norm(h)), in h's dtype."""
    p = layer["moe"]
    B, S, D = h.shape
    x = rms_norm(h, layer["ffn_norm"], config.norm_eps)
    y = routed_experts(x.reshape(B * S, D), p, config, counts).view(B, S, D)
    y = y + feed_forward(p["shared"], x, gates).float()
    return h + y.to(h.dtype)
