"""DeepSeek-V2's MoE and MLA on the card: the grouped expert product
(``torch._grouped_mm``) against its per-expert loop at DeepSeek-V2-Lite's
widths, a forward that reads nothing on the host, and a small bf16 model
against the same tree in float32 on the CPU. Needs an NVIDIA GPU; skips
without one (decided inside each test). Imports nothing of jax or of
``tests.*``. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py -q
"""

from __future__ import annotations

import pytest
import torch

from prego_tpu_torch.models.llama import moe
from prego_tpu_torch.models.llama.config import tiny_deepseek_v2_config
from prego_tpu_torch.models.llama.model import forward, init_cache, init_params, precompute_rope

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("tokens", [8, 32, 4096])
def test_grouped_product_matches_the_per_expert_loop(cuda_device, tokens):
    """64 experts of width 1408 over dim 2048, top 6 of random scores: the
    two grouped GEMMs against the loop over experts. Both round where the
    grouped products round (w13's output and the activation to bf16) and
    sum in f32, so they differ by the order of the sums: a bf16 ulp of an
    intermediate moves an output by well under 2% of the largest."""
    E, D, F, k = 64, 2048, 1408, 6
    g = torch.Generator(device=cuda_device).manual_seed(tokens)
    w13 = (torch.randn(E, D, 2 * F, generator=g, device=cuda_device) * D ** -0.5).bfloat16()
    w2 = (torch.randn(E, F, D, generator=g, device=cuda_device) * F ** -0.5).bfloat16()
    idx = torch.rand(tokens, E, generator=g, device=cuda_device).topk(k, dim=-1).indices
    ids, order = torch.sort(idx.reshape(-1), stable=True)
    offs = torch.searchsorted(ids, torch.arange(E, device=cuda_device), right=True,
                              out_int32=True)
    xs = torch.randn(tokens * k, D, generator=g, device=cuda_device).bfloat16()
    got = moe.grouped_swiglu(xs, w13, w2, offs)
    want = moe.grouped_swiglu_reference(xs, w13, w2, offs)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (tokens * k, D)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.02 * want.float().abs().max().item(), err


def _to(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def _tiny(device, dtype):
    cfg = tiny_deepseek_v2_config(max_seq_len=128, max_batch_size=4)
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    return cfg, _to(params, device, dtype)


def test_a_forward_reads_nothing_on_the_host(cuda_device):
    """Prefill, then decode at per-row positions, under the sync debug mode
    that raises on any synchronizing call: routing, the sort, the offsets,
    the grouped products, the counters' copy and the absorbed attention
    all stay on the card."""
    cfg, tree = _tiny(cuda_device, torch.bfloat16)
    rope = precompute_rope(cfg, device=cuda_device)
    counts = torch.zeros(cfg.n_moe_layers, cfg.n_routed_experts, dtype=torch.int32,
                         device=cuda_device)
    tokens = torch.randint(0, 256, (3, 32), device=cuda_device)
    pos = torch.tensor([20, 31, 9], dtype=torch.int32, device=cuda_device)
    for check in (False, True):  # the first pass builds the kernels
        cache = init_cache(cfg, 3, dtype=torch.bfloat16, device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if check else 0)
        try:
            _, cache = forward(tree, tokens, 0, cache, cfg, rope, counts)
            forward(tree, tokens[:, :1], pos, cache, cfg, rope, counts)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rows = counts.diff(dim=-1, prepend=counts.new_zeros(cfg.n_moe_layers, 1)).sum(-1)
    assert rows.tolist() == [3 * cfg.num_experts_per_tok] * cfg.n_moe_layers


def test_the_card_in_bf16_follows_the_cpu_in_float32(cuda_device):
    """The same tree, bf16 on the card (grouped products, bf16 GEMMs with
    f32 outputs in the absorbed attention, K7a and K7 at decode) and f32 on
    the CPU: prefill and one decode step's logits within bf16's reach
    (5% of their spread), the greedy token agreeing on most rows."""
    cfg, tree = _tiny(cuda_device, torch.bfloat16)
    cfg32, tree32 = _tiny(torch.device("cpu"), torch.float32)
    tokens = torch.randint(0, 256, (4, 24), generator=torch.Generator().manual_seed(1))
    outs = []
    for dev, t, c in ((cuda_device, tree, cfg), (torch.device("cpu"), tree32, cfg32)):
        rope = precompute_rope(c, device=dev)
        cache = init_cache(c, 4, dtype=t["norm"].dtype, device=dev)
        pre, cache = forward(t, tokens.to(dev), 0, cache, c, rope)
        step, _ = forward(t, tokens[:, :1].to(dev), 24, cache, c, rope)
        outs.append(torch.cat([pre, step], dim=1).float().cpu())
    got, want = outs
    spread = want.std().item()
    assert (got - want).abs().mean().item() <= 0.05 * spread
    assert (got.argmax(-1) == want.argmax(-1)).float().mean().item() >= 0.8
