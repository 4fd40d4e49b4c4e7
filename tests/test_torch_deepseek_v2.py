"""DeepSeek-V2 on the port's normal path (``models/llama/{mla,moe}.py`` through
``forward``, ``Llama`` and ``TorchLlamaLLM``) against the plain float32
reference ``tests/plain_deepseek_v2.py``, on seeded random weights at a
small size: dim 64, 4 heads, kv_lora_rank 32, rotary 16, 16 experts of
which 4 a token, 1 shared, 3 layers (the first dense).

Tolerances: both sides compute in float32 on the CPU, so they differ by
the order of sums alone (the absorbed attention against the decompressed
one, expert rows grouped against tokens one by one): 1e-4 absolute and
relative on logits of magnitude ~1, a hundred times f32's rounding over
these depths, and far below what a dropped or misrouted term moves them
(a token's expert swapped moves its logits by ~0.1). Token equality is
asserted only between two runs of the port that compute the same sums.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.plain_deepseek_v2 as plain
from prego_tpu_torch.models.llama import Llama, moe
from prego_tpu_torch.models.llama.config import (
    DeepseekV2Config, deepseek_v2_lite_config, tiny_deepseek_v2_config, tiny_test_config,
)
from prego_tpu_torch.models.llama.model import (
    _ffn_sublayer, forward, fuse_projections, fusion_gates, init_cache,
    init_params, precompute_rope, quantize_params,
)
from prego_tpu_torch.models.llama.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


def plain_config(cfg: DeepseekV2Config) -> dict:
    """The plain reference's dict of a config: the HF names it reads (the
    routed weights as the port takes them: not renormalised, unscaled)."""
    c = {**dataclasses.asdict(cfg), "norm_topk_prob": False, "routed_scaling_factor": 1.0}
    c["rope_scaling"] = {"type": "yarn", "factor": cfg.rope_factor,
                         "original_max_position_embeddings": cfg.rope_original_max_position,
                         "beta_fast": cfg.rope_beta_fast, "beta_slow": cfg.rope_beta_slow,
                         "mscale": cfg.rope_mscale, "mscale_all_dim": cfg.rope_mscale_all_dim}
    return c


@pytest.fixture(scope="module")
def model():
    cfg = tiny_deepseek_v2_config(max_seq_len=128, max_batch_size=4)
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    return cfg, params


def _tokens(seed, *lens):
    rng = np.random.default_rng(seed)
    return [[256] + [int(t) for t in rng.integers(0, 256, n - 1)] for n in lens]


def _ref(model, seqs):
    cfg, params = model
    return plain.logits(params, plain_config(cfg), seqs)


def test_prefill_logits_match_the_reference(model):
    cfg, params = model
    seqs = _tokens(0, 40, 40)
    cache = init_cache(cfg, 2, dtype=torch.float32)
    logits, _ = forward(params, torch.tensor(seqs), 0, cache, cfg, precompute_rope(cfg))
    for b, want in enumerate(_ref(model, seqs)):
        torch.testing.assert_close(logits[b], want, **TOL)


def test_decode_through_the_latent_cache_matches_the_full_forward(model):
    """A prefill of 20 tokens, then 12 single-token steps through the
    latent cache (the absorbed form), each against the reference's
    forward over the whole sequence at that position."""
    cfg, params = model
    (seq,) = _tokens(1, 32)
    rope = precompute_rope(cfg)
    cache = init_cache(cfg, 1, dtype=torch.float32)
    logits, cache = forward(params, torch.tensor([seq[:20]]), 0, cache, cfg, rope)
    got = [logits[0]]
    for p in range(20, 32):
        step, cache = forward(params, torch.tensor([[seq[p]]]), p, cache, cfg, rope)
        got.append(step[0])
    (want,) = _ref(model, [seq])
    torch.testing.assert_close(torch.cat(got), want, **TOL)


def test_the_cache_holds_the_normed_latent_and_the_rotated_key(model):
    """576 values a position and layer at full width (here R + dr = 48):
    cache "k" is rms_norm(c_kv), cache "v" the rotated k_pe, as the
    reference computes them for the first layer; nothing else is kept."""
    cfg, params = model
    (seq,) = _tokens(2, 24)
    cache = init_cache(cfg, 1, dtype=torch.float32)
    forward(params, torch.tensor([seq]), 0, cache, cfg, precompute_rope(cfg))
    assert set(cache) == {"k", "v"}
    T = cfg.max_seq_len
    assert [tuple(t.shape) for t in cache["k"]] == [(1, 1, T, cfg.kv_lora_rank)] * cfg.n_layers
    assert [tuple(t.shape) for t in cache["v"]] == [(1, 1, T, cfg.qk_rope_head_dim)] * cfg.n_layers
    c = plain_config(cfg)
    p = plain.f32_layer(params["layers"][0])
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    x = params["tok_embeddings"][torch.tensor(seq)]
    a = plain.rms_norm(x, p["attention_norm"], c["norm_eps"]) @ p["wqkv_a"]
    cos, sin = plain.yarn_tables(c, len(seq), x.device)
    k_pe = plain.rope(a[:, H * (dn + dr):H * (dn + dr) + dr][:, None], cos, sin)[:, 0]
    c_kv = plain.rms_norm(a[:, H * (dn + dr) + dr:], p["kv_norm"], c["norm_eps"])
    torch.testing.assert_close(cache["k"][0][0, 0, :24], c_kv, **TOL)
    torch.testing.assert_close(cache["v"][0][0, 0, :24], k_pe, **TOL)
    assert not cache["k"][0][0, 0, 24:].any()


def test_decode_never_decompresses_the_cache(model):
    """No op of a decode step outputs a tensor as large as the decompressed
    keys of the cache (B, T, H, qk_nope_head_dim)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, params = model
    seqs = _tokens(3, 30, 30)
    rope = precompute_rope(cfg)
    cache = init_cache(cfg, 2, dtype=torch.float32)
    _, cache = forward(params, torch.tensor(seqs), 0, cache, cfg, rope)
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else [out]:
                if isinstance(t, torch.Tensor):
                    sizes.append(t.numel())
            return out

    with Sizes():
        forward(params, torch.tensor([[5], [6]]), torch.tensor([30, 30], dtype=torch.int32),
                cache, cfg, rope)
    decompressed = 2 * cfg.max_seq_len * cfg.n_heads * cfg.qk_nope_head_dim
    assert sizes and max(sizes) < decompressed
    # the largest is the embedding, the cache or the lm-head; no (B, T, H, dn)
    assert max(sizes) <= max(cfg.vocab_size * cfg.dim, 2 * cfg.max_seq_len * cfg.kv_lora_rank)


def test_a_ragged_batch_equals_each_prompt_alone(model):
    """Per-row positions: a prefill of three prompts of 23, 31 and 17 tokens
    in one pad-filled buffer, then two decode steps at each row's own
    position; every row's logits equal the reference's over that row's
    own sequence, and greedy generation equals each prompt alone at B 1."""
    cfg, params = model
    seqs = _tokens(4, 23, 31, 17)
    nxt = [[7, 9], [11, 13], [15, 17]]
    rope = precompute_rope(cfg)
    buf = torch.full((3, 32), -1, dtype=torch.int64)
    for b, s in enumerate(seqs):
        buf[b, :len(s)] = torch.tensor(s)
    cache = init_cache(cfg, 3, dtype=torch.float32)
    logits, cache = forward(params, buf, 0, cache, cfg, rope)
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.int32)
    steps = []
    for t in range(2):
        out, cache = forward(params, torch.tensor([[n[t]] for n in nxt]), lens + t, cache, cfg,
                             rope)
        steps.append(out[:, 0])
    want = _ref(model, [s + n for s, n in zip(seqs, nxt)])
    for b, s in enumerate(seqs):
        got = torch.cat([logits[b, :len(s)], steps[0][b:b + 1], steps[1][b:b + 1]])
        torch.testing.assert_close(got, want[b][:len(s) + 2], **TOL)
    lm = Llama(params, ByteTokenizer(), cfg)
    batch, _ = lm.generate(seqs, 6, temperature=0.0)
    alone = [lm.generate([s], 6, temperature=0.0)[0][0] for s in seqs]
    assert batch == alone and lm.per_row_calls == 1


def test_prefix_cached_generation_equals_uncached(model):
    """Prompts sharing a 70-token head through the prefix LRU (one B 1
    latent cache, cloned to the batch) give the plain path's tokens."""
    cfg, params = model
    (head,) = _tokens(5, 70)
    prompts = [head + t[1:] for t in _tokens(6, 9, 14, 5)]
    lm = Llama(params, ByteTokenizer(), cfg)
    cached = lm.generate_with_prefix_cache(prompts, 6, temperature=0.0)
    plain_out, _ = lm.generate(prompts, 6, temperature=0.0)
    assert cached == plain_out
    assert lm.prefix_rebuilds == 1 and lm.prefix_tokens_reused == 3 * 64
    again = lm.generate_with_prefix_cache(prompts, 6, temperature=0.0)
    assert again == cached and lm.prefix_rebuilds == 1


def test_routing_is_the_unrenormalised_top_k_and_the_shared_experts_count_once(model):
    cfg, params = model
    layer = params["layers"][1]
    p = layer["moe"]
    h = torch.randn(2, 5, cfg.dim, generator=torch.Generator().manual_seed(7))
    x = plain.rms_norm(h, layer["ffn_norm"], cfg.norm_eps).reshape(10, cfg.dim)
    w, idx = moe.route(x, p["gate"], cfg)
    s = torch.softmax(x @ p["gate"], dim=-1)
    top = s.topk(cfg.num_experts_per_tok, dim=-1)
    torch.testing.assert_close(w, top.values, **TOL)
    assert torch.equal(idx, top.indices)
    assert (w.sum(-1) < 1).all()  # the scores as they are, not renormalised

    def swiglu(v, w13, w2):
        g = v @ w13
        F = w2.shape[0]
        return (torch.nn.functional.silu(g[:, :F]) * g[:, F:]) @ w2

    want = swiglu(x, p["shared"]["w13"], p["shared"]["w2"])  # the shared experts once
    for n in range(10):
        for k in range(cfg.num_experts_per_tok):
            e = int(top.indices[n, k])
            want[n] += top.values[n, k] * swiglu(x[n:n + 1], p["w13"][e], p["w2"][e])[0]
    got = moe.sublayer(layer, h, cfg, fusion_gates())
    torch.testing.assert_close(got, h + want.view(2, 5, -1), **TOL)


def test_layer_zero_is_the_dense_swiglu(model):
    cfg, params = model
    kinds = ["moe" in lp for lp in params["layers"]]
    assert kinds == [False, True, True]
    lp = params["layers"][0]
    assert tuple(lp["feed_forward"]["w13"].shape) == (cfg.dim, 2 * cfg.intermediate_size)
    h = torch.randn(1, 4, cfg.dim, generator=torch.Generator().manual_seed(8))
    p = plain.f32_layer(lp)
    want = plain.ffn(h[0], p, plain_config(cfg))
    torch.testing.assert_close(_ffn_sublayer(lp, h, cfg, fusion_gates())[0], want, **TOL)


def test_yarn_tables_and_softmax_scale_follow_the_published_formula():
    """DeepSeek-V2-Lite's: 192^-0.5 (0.1 * 0.707 * ln 40 + 1)^2 = 0.11472;
    inverse frequencies ramped between 1/(40 * 10000^(2i/64)) and
    1/10000^(2i/64) over the correction dims of beta 32 and 1 at 4096
    (floor 10.47 = 10, ceil 22.51 = 23); cos and sin unscaled (mscale over
    mscale_all_dim is 1)."""
    import math

    cfg = deepseek_v2_lite_config()
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert cfg.softmax_scale == pytest.approx(0.11472, abs=1e-5)
    i = np.arange(32)
    base = 10000.0 ** (2 * i / 64)

    def corr(rot):
        return 64 * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(10000))

    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    inv = ramp / (40 * base) + (1 - ramp) / base
    cos, sin = precompute_rope(cfg)
    assert tuple(cos.shape) == (2 * cfg.max_seq_len, 32)
    t = np.arange(2 * cfg.max_seq_len)[:, None]
    np.testing.assert_allclose(cos.numpy(), np.cos(t * inv[None, :].astype(np.float32)),
                               atol=2e-4)  # f32 angles of up to 2047 rad
    np.testing.assert_allclose(sin.numpy(), np.sin(t * inv[None, :].astype(np.float32)),
                               atol=2e-4)
    assert cfg.rope_cos_scale == 1.0


def test_counters_count_top_k_rows_a_token_and_read_nothing_inside_a_step(model, monkeypatch):
    """Every MoE layer-forward's rows sum to top-k x the forward's tokens;
    the counters total them; and a forward reads nothing from the device
    on the host outside the CPU's plain expert loop (the card's grouped
    product reads nothing either: tests/test_torch_cuda_moe.py)."""
    cfg, params = model
    lm = Llama(params, ByteTokenizer(), cfg)
    prompts = _tokens(9, 12, 19)
    reads = []
    inside = []
    plain_loop = moe.grouped_swiglu

    def loop(*a, **k):
        inside.append(True)
        try:
            return plain_loop(*a, **k)
        finally:
            inside.pop()

    def forbid(name):
        real = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            if not inside and generation_running:
                reads.append(name)
            return real(self, *a, **k)
        return read

    generation_running = False
    monkeypatch.setattr(moe, "grouped_swiglu", loop)
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, forbid(name))
    from prego_tpu_torch.models.llama import generation

    real_forward = generation.forward

    def watched(*a, **k):
        nonlocal generation_running
        generation_running = True
        try:
            return real_forward(*a, **k)
        finally:
            generation_running = False

    monkeypatch.setattr(generation, "forward", watched)
    lm.generate(prompts, 5, temperature=0.0)
    assert reads == []
    counts = lm.moe_last_counts
    k, L, E = cfg.num_experts_per_tok, cfg.n_moe_layers, cfg.n_routed_experts
    buf = 64  # the prefill's pad-filled buffer
    assert counts.shape == (1 + 5, L, E)  # the prefill and 5 steps
    assert (counts.sum(-1) == np.array([[k * 2 * buf] * L] + [[k * 2] * L] * 5)).all()
    assert lm.moe_assignments == int(counts.sum())
    assert lm.moe_expert_hits == int((counts > 0).sum())
    assert lm.moe_rows_max == int(counts.max(-1).sum())


def _llama_ops():
    """The aten ops of a LLaMA forward (prefill, scalar decode, per-row
    decode) on a tiny config, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = dataclasses.replace(tiny_test_config(64), max_seq_len=32, max_batch_size=2)
    params = fuse_projections(init_params(cfg, torch.Generator().manual_seed(0),
                                          dtype=torch.float32))
    rope = precompute_rope(cfg)
    cache = init_cache(cfg, 2, dtype=torch.float32)
    ops = {}

    class Record(TorchDispatchMode):
        def __init__(self, log):
            super().__init__()
            self.log = log

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.log.append(str(func))
            return func(*args, **(kwargs or {}))

    for name, tokens, pos in (("prefill", torch.ones(2, 8, dtype=torch.long), 0),
                              ("decode", torch.ones(2, 1, dtype=torch.long), 8),
                              ("per_row", torch.ones(2, 1, dtype=torch.long),
                               torch.tensor([9, 5], dtype=torch.int32))):
        ops[name] = []
        with Record(ops[name]):
            forward(params, tokens, pos, cache, cfg, rope)
    return ops


def test_the_llama_forward_launches_the_same_ops_as_before():
    """The LLaMA block's forward runs the op sequence it ran before MLA and
    MoE came in (tests/golden/llama_forward_ops.json, recorded from the
    forward without them): no op a layer or a step added."""
    golden = json.loads((REPO / "tests" / "golden" / "llama_forward_ops.json").read_text())
    assert _llama_ops() == golden


@pytest.mark.parametrize("kwargs", [
    {"quantize": "int8"}, {"quantize": "int8x8"}, {"kv_quant": True}, {"serving": "cb"},
    {"spec_k": 2, "spec_draft": "self-1"}, {"tp": 2},
], ids=["int8", "int8x8", "kv_quant", "cb", "spec_k", "tp"])
def test_torch_llama_refuses_what_the_config_does_not_take(model, kwargs):
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    cfg, params = model
    with pytest.raises(ValueError, match="MLA/MoE"):
        TorchLlamaLLM(params=params, config=cfg, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="MLA/MoE"):
        TorchLlamaLLM(fabricated="dsv2-tiny", device="cpu", **kwargs)


def test_the_library_paths_refuse_the_config(model):
    from prego_tpu_torch.models.llama.speculative import SpeculativeLlama
    from prego_tpu_torch.parallel.sharding import llama_tp_config
    from prego_tpu_torch.serving_llm import ContinuousBatcher

    cfg, params = model
    lm = Llama(params, ByteTokenizer(), cfg)
    for call in (lambda: quantize_params(params), lambda: init_cache(cfg, 1, quantized=True),
                 lambda: Llama(params, ByteTokenizer(), cfg, kv_quant=True),
                 lambda: ContinuousBatcher(lm), lambda: SpeculativeLlama(lm, k=2),
                 lambda: llama_tp_config(cfg, None)):
        with pytest.raises(ValueError, match="MLA/MoE"):
            call()


def test_torch_llama_serves_the_tree_as_it_comes(model):
    """params= with the config: the same tensors, no fusing; the batch path
    answers and the counters move."""
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    cfg, params = model
    llm = TorchLlamaLLM(params=params, config=cfg, device="cpu")
    assert llm.llama.params is params
    out = llm.text_completion(["Next Symbol:\n"] * 2, max_gen_len=4, temperature=0.0)
    assert len(out) == 2 and llm.llama.moe_assignments > 0
    fab = TorchLlamaLLM(fabricated="dsv2-tiny", device="cpu", max_seq_len=96)
    assert isinstance(fab.llama.config, DeepseekV2Config)
    assert fab.llama.config.max_seq_len == 96 and "moe" in fab.llama.params["layers"][-1]


def test_the_cli_serves_dsv2_and_prints_the_moe_counters(tmp_path):
    code = (
        "from prego_tpu_torch.cli.anticipate import main\n"
        "main(['--llm', 'torch-llama', '--fabricated', 'dsv2-tiny', '--dataset', 'synthcustom',\n"
        f"      '--seqs', {str(REPO / 'tests' / 'golden' / 'synth_seqs.json')!r},\n"
        f"      '--results_root', {str(tmp_path / 'results')!r}, '--max_gen_len', '3',\n"
        "      '--max_seq_len', '256', '--device', 'cpu'])\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (line,) = [ln for ln in proc.stderr.splitlines() if "prefix cache:" in ln]
    fields = dict(kv.split("=") for kv in line.split("moe: ")[1].split())
    assert int(fields["assignments"]) > 0
    assert 0 < int(fields["rows_max"]) <= int(fields["assignments"])
    assert int(fields["expert_hits"]) > 0
