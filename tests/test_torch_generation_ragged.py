"""Batch generation over prompts of different lengths, on a tiny CPU model:
every row decodes from its own prompt end at per-row positions, so a
call runs max_gen_len decode steps and no step feeds a prompt token.
Greedy tokens equal each prompt served alone and the JAX package's
(which feeds the longer rows' prompt tails one step at a time); a row
that reaches the cache's end stops there while the others go on, and
its later feeds write only the cache's spare tail. Batches of equal
lengths keep the scalar path, token for token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
from prego_tpu.models.llama import Llama as JaxLlama
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config as jax_tiny_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.core.seed import make_generator
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, generation, tiny_test_config
from prego_tpu_torch.models.llama.model import forward, fuse_projections, init_params
from prego_tpu_torch.ops.sampling import sample_next_token

GEN = 8  # max_gen_len: at most EOS_CHECK_EVERY steps, so no early stop


def _head(n=70):
    return [256] + [40 + i % 50 for i in range(n)]


# suffixes of 3 to 43 tokens past a 70-token shared head: lengths differ by 1-40
RAGGED = [_head() + [100 + 3 * j + i % 7 for i in range(n)]
          for j, n in enumerate((12, 3, 43, 4))]


def _torch_llama(fused, kv_quant, dtype, max_seq_len=256):
    cfg = dataclasses.replace(tiny_test_config(vocab_size=258), max_seq_len=max_seq_len)
    params = init_params(cfg, torch.Generator().manual_seed(5), dtype=dtype)
    return Llama(fuse_projections(params) if fused else params, ByteTokenizer(), cfg,
                 kv_quant=kv_quant)


@pytest.fixture(scope="module")
def jax_weights():
    jcfg = jax_tiny_config(vocab_size=258)
    return jcfg, jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(2),
                                                          dtype=jnp.float32))


def _pair(jax_weights, fused, kv_quant, max_seq_len):
    """The JAX package's Llama and the port's on the same f32 weights."""
    jcfg, jparams = jax_weights
    jcfg = dataclasses.replace(jcfg, max_seq_len=max_seq_len)
    tcfg = dataclasses.replace(tiny_test_config(vocab_size=258), max_seq_len=max_seq_len)
    p = jax_fuse(jparams) if fused else jparams
    return (JaxLlama(p, JaxByteTokenizer(), jcfg, kv_quant=kv_quant),
            Llama(llama_from_numpy(jax.tree.map(np.asarray, p)), ByteTokenizer(), tcfg,
                  kv_quant=kv_quant))


def _run(lm, path, prompts, gen_len=GEN):
    if path == "prefix":
        return lm.generate_with_prefix_cache(prompts, gen_len, temperature=0.0)
    return lm.generate(prompts, gen_len, temperature=0.0)[0]


@pytest.mark.parametrize("path", ["plain", "prefix"])
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_ragged_batch_equals_each_prompt_alone(fused, kv_quant, path):
    """bf16 weights: each row's greedy tokens are its own B=1 call's; the
    call runs max_gen_len steps at per-row positions and no tail step."""
    lm = _torch_llama(fused, kv_quant, torch.bfloat16)
    got = _run(lm, path, RAGGED)
    assert (lm.decode_steps, lm.per_row_calls) == (GEN, 1)
    assert all(len(g) == GEN and lm.tokenizer.eos_id not in g for g in got)
    alone = [_run(lm, path, [p])[0] for p in RAGGED]
    assert got == alone
    assert lm.per_row_calls == 1  # B = 1 calls take the scalar path


@pytest.mark.parametrize("path", ["plain", "prefix"])
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_ragged_batch_matches_jax(jax_weights, fused, kv_quant, path):
    """f32 weights: the greedy tokens equal the JAX package's generate,
    which starts every row at the shortest prompt and feeds the tails."""
    jl, tl = _pair(jax_weights, fused, kv_quant, 256)
    want, _ = jl.generate(RAGGED, max_gen_len=GEN, temperature=0.0)
    assert _run(tl, path, RAGGED) == want
    assert (tl.decode_steps, tl.per_row_calls) == (GEN, 1)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_equal_lengths_keep_the_scalar_path(monkeypatch, kv_quant):
    """Prompts of one length: no per-row call, scalar positions only, and
    the greedy and sampled tokens of a plain prefill-then-decode loop at
    one position a step, drawing from the same sampler stream."""
    lm = _torch_llama(True, kv_quant, torch.bfloat16)
    L = min(len(p) for p in RAGGED)
    prompts = [p[:L] for p in RAGGED]
    seen = []
    orig = generation.forward

    def spy(params, tokens, start_pos, *a, **k):
        seen.append(start_pos)
        return orig(params, tokens, start_pos, *a, **k)

    monkeypatch.setattr(generation, "forward", spy)
    for temperature in (0.0, 0.8):
        lm.generator = make_generator(1, lm.device)
        got, _ = lm.generate(prompts, GEN, temperature=temperature)
        # the loop of fixed positions: prefill of the pad-filled buffer,
        # then token t fed at L + t
        cache = lm._new_cache(len(prompts))
        gen_ = make_generator(1, lm.device)
        buf = torch.full((len(prompts), 128), -1, dtype=torch.int64)
        buf[:, :L] = torch.tensor(prompts)
        logits, cache = forward(lm.params, buf, 0, cache, lm.config, lm.rope)
        last, want = logits[:, L - 1], []
        for t in range(GEN):
            nxt = sample_next_token(last, temperature, 0.9, gen_)
            want.append(nxt)
            logits, cache = forward(lm.params, nxt[:, None], L + t, cache, lm.config, lm.rope)
            last = logits[:, 0]
        want = torch.stack(want, dim=1).tolist()
        want = [w[: w.index(257)] if 257 in w else w for w in want]
        assert got == want
    assert all(isinstance(s, int) for s in seen)
    assert lm.per_row_calls == 0 and lm.decode_steps == 2 * GEN


@pytest.mark.parametrize("path", ["plain", "prefix"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_a_row_stops_at_the_cache_end(monkeypatch, jax_weights, kv_quant, path):
    """max_seq_len 128: the longest row has 4 positions of cache left, the
    others GEN or more. It emits 4 tokens and stops while the others go
    on; its tokens equal the JAX package's. Each decode step writes each
    row's own position only, and the stopped row's feeds go to the
    spare position past max_seq_len, never over a key of the cache."""
    T = 128
    jl, tl = _pair(jax_weights, True, kv_quant, T)
    prompts = [_head() + [100 + i % 9 for i in range(n)] for n in (40, 53, 29)]
    lens = [len(p) for p in prompts]  # 111, 124, 100
    gen_len = 12
    snaps, positions = [], []
    orig = generation.forward

    def leaf(x):
        return torch.cat([x["q"].float(), x["s"].float()[..., None]], -1) if isinstance(
            x, dict) else x.clone()

    def spy(params, tokens, start_pos, cache, *a, **k):
        out = orig(params, tokens, start_pos, cache, *a, **k)
        if tokens.shape[0] == len(prompts):
            positions.append(start_pos)
            snaps.append([leaf(x) for x in out[1]["k"]])
        return out

    monkeypatch.setattr(generation, "forward", spy)
    got = _run(tl, path, prompts, gen_len)
    want, _ = jl.generate(prompts, max_gen_len=gen_len, temperature=0.0)
    assert got == want
    assert [len(g) for g in got] == [gen_len, T - lens[1], gen_len]
    assert tl.decode_steps == gen_len and tl.per_row_calls == 1
    assert snaps[0][0].shape[2] == T + 1  # the spare position past max_seq_len
    for t in range(1, len(snaps)):
        pos = positions[t].tolist()
        assert pos == [n + t - 1 for n in lens]
        for layer in range(len(snaps[t])):
            changed = (snaps[t][layer] != snaps[t - 1][layer]).any(-1).any(1)  # (B, T + 1)
            for b, p in enumerate(pos):
                allowed = {min(p, T)}  # a row's own slot, or the spare past the cache
                assert set(torch.nonzero(changed[b])[:, 0].tolist()) <= allowed, (t, b, p)
    # the stopped row's spare slot was written: its feeds went there
    assert snaps[-1][0][1, :, T].abs().sum() > 0
