"""The per-row decode step replayed from a captured CUDA graph over the
persistent cache (``generation.py``: ``replays_decode``, ``_DecodeGraph``,
``model.load_rows``).

On the CPU: the rule that decides where the graph engages, held by its
inputs; a call's rows loaded in place in the persistent store, at T and at
T + 1 in the same memory; a call after another one, which left its keys in
the store, gives what it gives on a fresh model; the graph counters
present and 0, with no capture span; the CLI's closing line carrying them.

On the card (marker ``cuda``; each test skips without one): replay against
the eager loop bit for bit, tokens and logprobs, greedy and sampled under
the same sampler seed, at a 2-layer Mistral-7B width and a 3-layer cut of
DeepSeek-V2-Lite (its dense layer 0 and two MoE layers, with their
counters), at B 8, 13 and 32, and the kernels' launch counts equal;
one capture a key, reused by later calls;
the spare tail's own key; a scalar-position call eager; a changed fusion
gate its own key. Imports nothing of jax or of ``tests.*``. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py -q
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from prego_tpu_torch.cli.anticipate import prefix_cache_line
from prego_tpu_torch.core import profiling
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, generation, tiny_test_config
from prego_tpu_torch.models.llama.config import (
    LlamaConfig, TensorParallelConfig, deepseek_v2_lite_config, tiny_deepseek_v2_config,
)
from prego_tpu_torch.models.llama.model import (
    clone_cache, fuse_projections, init_cache, init_params, load_rows, quantize_params,
)
from prego_tpu_torch.ops._cuda import CudaKernel

CAPTURE = "prego.generate.capture"
GEN = 12  # max_gen_len: past EOS_CHECK_EVERY, so the all-done check runs too


def _ragged(B, head=70, seed=0):
    """B prompts sharing ``head`` tokens after bos, then tails of 3 to 40."""
    rng = np.random.default_rng(seed)
    first = [256] + [int(t) for t in rng.integers(0, 256, head)]
    return [first + [int(t) for t in rng.integers(0, 256, 3 + (7 * i) % 38)] for i in range(B)]


# ---- the CPU ----

@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("tp", [False, True])
def test_graphs_engage_only_on_the_card_per_row_without_tp(device, per_row, tp):
    """The rule reads a device, the call's kind of position and the
    config's tp group; a CUDA device object needs no card."""
    cfg = (TensorParallelConfig(**dataclasses.asdict(LlamaConfig()), tp_group=object()) if tp
           else LlamaConfig())
    got = generation.replays_decode(torch.device(device), per_row, cfg)
    assert got is (device == "cuda" and per_row and not tp)


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("spare", [0, 1])
@pytest.mark.parametrize("kind", ["bf16", "int8", "latent"])
def test_load_rows_loads_a_call_in_place_in_the_store(prefix, spare, kind):
    """A call's B rows at T = max_seq_len + ``spare``, taken from a stale
    store of 6 rows at T + 1, hold the prefix's row over its positions and
    zeros past them (zeros everywhere without a prefix), contiguous at the
    start of each leaf's memory; the store's other memory is left as it
    was."""
    cfg = (dataclasses.replace(tiny_deepseek_v2_config(), max_batch_size=6)
           if kind == "latent" else dataclasses.replace(tiny_test_config(258), max_batch_size=6))
    quantized = kind == "int8"
    whole = init_cache(cfg, 6, dtype=torch.float32, quantized=quantized, spare=1)
    src = init_cache(cfg, 1, dtype=torch.float32, quantized=quantized)
    g = torch.Generator().manual_seed(spare)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        return t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))

    whole = {key: [fill(t) for t in whole[key]] for key in ("k", "v")}
    src = {key: [fill(t) for t in src[key]] for key in ("k", "v")}
    before = clone_cache(whole)
    rows = load_rows(whole, 4, cfg.max_seq_len + spare, src if prefix else None)
    want = init_cache(cfg, 4, dtype=torch.float32, quantized=quantized, spare=spare)

    def leaves(c):
        for key in ("k", "v"):
            for t in c[key]:
                yield from (t.values() if isinstance(t, dict) else (t,))

    if prefix:
        for w, one in zip(leaves(want), leaves(src)):
            w[:, :, : one.shape[2]] = one
    for got, w, dst, old in zip(leaves(rows), leaves(want), leaves(whole), leaves(before)):
        assert torch.equal(got, w)
        assert got.data_ptr() == dst.data_ptr() and got.is_contiguous()
        assert torch.equal(dst.view(-1)[got.numel():], old.view(-1)[got.numel():])


def _tiny_llama(kind):
    if kind == "latent":
        cfg = tiny_deepseek_v2_config(max_seq_len=256)
        return Llama(init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32),
                     ByteTokenizer(), cfg)
    cfg = dataclasses.replace(tiny_test_config(vocab_size=258), max_seq_len=256)
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    return Llama(fuse_projections(params), ByteTokenizer(), cfg)


@pytest.mark.parametrize("kind", ["llama", "latent"])
def test_cpu_calls_run_eagerly_with_the_graph_counters_at_zero(kind, tmp_path):
    """A per-row call on the CPU, plain and prefix-cached, under a profiler:
    its steps counted over the persistent store, no capture, no replay and
    no capture span; the CLI's closing line carries both counters."""
    lm = _tiny_llama(kind)
    prompts = _ragged(3)
    with profiling.trace(str(tmp_path)) as prof:
        lm.generate(prompts, 4, temperature=0.0)
        lm.generate_with_prefix_cache(prompts, 4, temperature=0.0)
    assert lm.per_row_calls == 2 and lm.decode_steps == 8
    assert (lm.decode_graph_captures, lm.decode_graph_replays) == (0, 0)
    assert lm._decode_cache["k"][0].shape[0] == lm.config.max_batch_size
    assert not lm._decode_graphs
    assert not [e for e in prof.events() if e.name == CAPTURE]
    line = prefix_cache_line(types.SimpleNamespace(llama=lm))
    assert "decode_steps=8 graph_captures=0 graph_replays=0" in line, line


@pytest.mark.parametrize("path", ["plain", "prefix"])
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("kind", ["llama", "latent"])
def test_a_call_after_another_gives_what_a_fresh_model_gives(kind, ragged, path):
    """Calls share the persistent store: a call after one that wrote
    longer rows, more of them and the spare tail gives the tokens and
    logprobs of the same call on a fresh model, at per-row and at scalar
    positions, plain and prefix-cached."""
    lm, fresh = _tiny_llama(kind), _tiny_llama(kind)
    run = {"plain": lambda m, p: m.generate(p, 6, temperature=0.0, logprobs=True),
           "prefix": lambda m, p: m.generate_with_prefix_cache(p, 6, temperature=0.0)}[path]
    long = [p + [66] * (250 - len(p)) if i % 2 else p for i, p in enumerate(_ragged(6, seed=4))]
    run(lm, long)
    assert lm._decode_cache["k"][0].shape[2] == lm.config.max_seq_len + 1
    prompts = _ragged(3, seed=5) if ragged else [p[:50] for p in _ragged(3, seed=5)]
    assert run(lm, prompts) == run(fresh, prompts)


def test_cli_line_is_none_without_a_torch_llama():
    assert prefix_cache_line(types.SimpleNamespace()) is None


# ---- the card ----

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def models(cuda_device):
    """bf16 trees on the card: 2 layers at Mistral-7B's widths, their int8
    quantization, and 3 layers of DeepSeek-V2-Lite (dense layer 0, two MoE)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    mistral = LlamaConfig(dim=4096, n_layers=2, n_heads=32, n_kv_heads=8, vocab_size=32000,
                          multiple_of=256, ffn_dim_multiplier=1.3125, norm_eps=1e-5,
                          max_batch_size=32, max_seq_len=512)
    m_params = fuse_projections(init_params(mistral, g, device=cuda_device))
    dsv2 = dataclasses.replace(deepseek_v2_lite_config(max_seq_len=512), n_layers=3)
    return {"mistral": (mistral, m_params),
            "mistral-int8": (mistral, quantize_params(m_params)),
            "dsv2": (dsv2, init_params(dsv2, g, device=cuda_device))}


def _pair(models, kind, monkeypatch):
    """(a Llama that replays, one that runs eagerly) on the same tree and
    sampler seed."""
    monkeypatch.setenv("PREGO_SAMPLE_SEED", "5")
    cfg, params = models[kind]
    kv_quant = kind.endswith("int8")
    return (Llama(params, ByteTokenizer(), cfg, kv_quant=kv_quant),
            Llama(params, ByteTokenizer(), cfg, kv_quant=kv_quant))


def _eager(monkeypatch, fn, *args, **kwargs):
    with monkeypatch.context() as m:
        m.setattr(generation, "replays_decode", lambda *a: False)
        return fn(*args, **kwargs)


def _moe(lm):
    return (lm.moe_assignments, lm.moe_expert_hits, lm.moe_rows_max)


def _counted(fn, *args, **kwargs):
    """``fn``'s result and the launches each kernel library's entry points
    counted in it (K7's and K7a's rings share a library)."""
    before = {k: k.launches for k in CudaKernel.instances}
    out = fn(*args, **kwargs)
    return out, {(k.name, *k.functions): k.launches - before.get(k, 0)
                 for k in CudaKernel.instances if k.launches != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.6])
@pytest.mark.parametrize("B", [8, 13, 32])
@pytest.mark.parametrize("kind", ["mistral", "dsv2"])
def test_replay_equals_the_eager_loop_bit_for_bit(models, monkeypatch, kind, B, temperature):
    """A plain call with logprobs, then a prefix-cached call at the same B:
    tokens, logprobs and MoE counters equal the eager loop's; the first
    call captures its key at step 0 and replays every later step, the
    second replays every step. Each kernel library counts the launches of
    the eager loop: a replay's, and none for the capture."""
    lm, ref = _pair(models, kind, monkeypatch)
    prompts = _ragged(B, seed=B)
    got, got_n = _counted(lm.generate, prompts, GEN, temperature=temperature, top_p=0.9,
                          logprobs=True)
    want, want_n = _counted(_eager, monkeypatch, ref.generate, prompts, GEN,
                            temperature=temperature, top_p=0.9, logprobs=True)
    assert got == want
    assert got_n == want_n and want_n, (got_n, want_n)
    if kind == "mistral":  # K7a's ring: one launch a decode step and layer, as K2's
        assert got_n[("fused_ffn_bf16", "prego_fused_ffn_block_tma")] == got_n[
            ("decode_attention", "prego_decode_attention")] > 0, got_n
    steps = lm.decode_steps
    assert steps == ref.decode_steps and lm.per_row_calls == 1
    assert (lm.decode_graph_captures, lm.decode_graph_replays) == (1, steps - 1)
    assert list(lm._decode_graphs)[0][:2] == (B, 512)
    got, got_n = _counted(lm.generate_with_prefix_cache, prompts, GEN,
                          temperature=temperature, top_p=0.9)
    want, want_n = _counted(_eager, monkeypatch, ref.generate_with_prefix_cache, prompts, GEN,
                            temperature=temperature, top_p=0.9)
    assert got == want and got_n == want_n
    assert lm.decode_graph_captures == 1
    assert lm.decode_graph_replays == lm.decode_steps - 1 == ref.decode_steps - 1
    assert (ref.decode_graph_captures, ref.decode_graph_replays) == (0, 0)
    if kind == "dsv2":
        assert _moe(lm) == _moe(ref) and _moe(lm)[0] > 0
        assert np.array_equal(lm.moe_last_counts, ref.moe_last_counts)


@pytest.mark.cuda
def test_int8_weights_and_cache_replay_as_eager(models, monkeypatch):
    """Weight-only int8 projections (K4) over the int8 cache (K3): the
    persistent cache takes the int8 layout, and replay equals eager."""
    lm, ref = _pair(models, "mistral-int8", monkeypatch)
    prompts = _ragged(13, seed=1)
    got = lm.generate(prompts, GEN, temperature=0.6, top_p=0.9, logprobs=True)
    assert got == _eager(monkeypatch, ref.generate, prompts, GEN, temperature=0.6, top_p=0.9,
                         logprobs=True)
    assert (lm.decode_graph_captures, lm.decode_graph_replays) == (1, lm.decode_steps - 1)
    assert isinstance(lm._decode_cache["k"][0], dict)


@pytest.mark.cuda
def test_spare_tail_scalar_calls_and_gates_take_their_own_paths(models, monkeypatch,
                                                                tmp_path):
    """On one model: a new key opens one capture span and a repeated one
    none; a call whose longest row runs past the cache replays under T + 1,
    equal to eager; a call of equal lengths (scalar positions) runs
    eagerly; a changed fusion gate captures its own key, equal to eager."""
    lm, ref = _pair(models, "mistral", monkeypatch)
    long = [p + [65] * (505 - len(p)) if i % 2 else p for i, p in enumerate(_ragged(8, seed=3))]
    got = lm.generate(long, GEN, temperature=0.6, top_p=0.9, logprobs=True)
    assert got == _eager(monkeypatch, ref.generate, long, GEN, temperature=0.6, top_p=0.9,
                         logprobs=True)
    assert [k[:2] for k in lm._decode_graphs] == [(8, 513)]
    store = lm._decode_cache

    prompts = _ragged(8, seed=2)
    for spans in (1, 0):
        with profiling.trace(str(tmp_path)) as prof:
            lm.generate(prompts, GEN, temperature=0.0)
        host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
        assert sum(e.name == CAPTURE for e in host) == spans
    assert [k[:2] for k in lm._decode_graphs] == [(8, 513), (8, 512)]
    assert lm.decode_graph_captures == 2 and lm._decode_cache is store  # T in T + 1's memory

    replays = lm.decode_graph_replays
    equal = [p[:60] for p in prompts]
    assert lm.generate(equal, GEN, temperature=0.0) == _eager(monkeypatch, ref.generate,
                                                              equal, GEN, temperature=0.0)
    assert (lm.decode_graph_captures, lm.decode_graph_replays) == (2, replays)

    monkeypatch.setenv("PREGO_FUSED_LAYER", "0")  # rms_norm and K7 in place of K7a
    got = lm.generate(prompts, GEN, temperature=0.0, logprobs=True)
    assert got == _eager(monkeypatch, ref.generate, prompts, GEN, temperature=0.0,
                         logprobs=True)
    assert lm.decode_graph_captures == 3 and len(lm._decode_graphs) == 3
