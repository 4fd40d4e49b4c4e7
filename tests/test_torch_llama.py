"""LLaMA parity on a tiny config: the port's forward, generation, prefix
cache and sampler against prego_tpu's, with the JAX weights handed over
through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
from prego_tpu.models.llama import Llama as JaxLlama
from prego_tpu.models.llama import forward as jax_forward
from prego_tpu.models.llama import init_cache as jax_init_cache
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu.ops.sampling import sample_top_p as jax_sample_top_p
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, to_numpy_tree
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama.model import forward, fuse_projections, init_cache
from prego_tpu_torch.ops.sampling import sample_top_p
from tests.torch_parity import n, t

# f32 weights and activations on both sides; logits differ only by the
# summation order of the products, over 2 layers of width 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _config():
    c = tiny_test_config(vocab_size=258)  # the byte tokenizer's vocabulary
    return c, LlamaConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__})


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _config()
    jparams = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                       dtype=jnp.float32))
    return jcfg, tcfg, jparams


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_logits_match_jax(weights, fused):
    jcfg, tcfg, jparams = weights
    jp = jax_fuse(jparams) if fused else jparams
    tp = llama_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(1)
    B, S = 2, 11
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)

    jl, jc = jax_forward(jp, jnp.asarray(toks), jnp.int32(0), jax_init_cache(jcfg, B,
                                                                              jnp.float32), jcfg)
    tl, tc = forward(tp, t(toks).long(), 0, init_cache(tcfg, B, torch.float32), tcfg)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    for step in range(3):  # single-token decode continues from the cache
        nxt = rng.integers(0, 256, (B, 1)).astype(np.int32)
        jl, jc = jax_forward(jp, jnp.asarray(nxt), jnp.int32(S + step), jc, jcfg)
        tl, tc = forward(tp, t(nxt).long(), S + step, tc, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), **TOL)
    np.testing.assert_allclose(n(tc["k"][1]), n(jc["k"][1]), **TOL)


def test_fuse_projections_matches_jax(weights):
    _, _, jparams = weights
    tp = fuse_projections(llama_from_numpy(jparams))
    want = jax.tree.map(np.asarray, jax_fuse(jparams))
    for a, b in zip(jax.tree.leaves(to_numpy_tree(tp)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _prompts():
    return [
        "Input Sequence:\n 3, 1, 4\nOutput:\n",
        "Input Sequence:\n 3, 1\nOutput:\n",
        "abc",
    ]


def test_greedy_generation_matches_jax(weights):
    jcfg, tcfg, jparams = weights
    jl = JaxLlama(jax_fuse(jparams), JaxByteTokenizer(), jcfg)
    tl = Llama(llama_from_numpy(jax_fuse(jparams)), ByteTokenizer(), tcfg)
    want = jl.text_completion(_prompts(), temperature=0.0, max_gen_len=12)
    got = tl.text_completion(_prompts(), temperature=0.0, max_gen_len=12)
    assert got == want
    # eos inside the generated span: tokens stop at the same place
    jt, _ = jl.generate([[256, 65, 66]], max_gen_len=20, temperature=0.0)
    tt, _ = tl.generate([[256, 65, 66]], max_gen_len=20, temperature=0.0)
    assert tt == jt


def test_logprobs_match_jax(weights):
    jcfg, tcfg, jparams = weights
    jl = JaxLlama(jparams, JaxByteTokenizer(), jcfg)
    tl = Llama(llama_from_numpy(jparams), ByteTokenizer(), tcfg)
    prompts = [[256, 70, 71, 72, 73], [256, 70, 71]]
    jt, jlp = jl.generate(prompts, max_gen_len=6, temperature=0.0, echo=True, logprobs=True)
    tt, tlp = tl.generate(prompts, max_gen_len=6, temperature=0.0, echo=True, logprobs=True)
    assert tt == jt
    for a, b in zip(tlp, jlp):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


CTX = "context line; " * 5  # 70 bytes
PREFIX_BATCHES = [
    [CTX + "3, 1\n", CTX + "3, 1, 4\n"],  # shared prefix 64: built
    [CTX * 2 + "7\n", CTX * 2 + "7, 2\n"],  # prefix 128: extended from 64
    [CTX + "9\n"],  # prefix 64 again: an LRU hit
]


def test_prefix_cached_generation_matches_jax(weights):
    """Shared contexts of 70 and 140 tokens: the prefix LRU builds the
    64-token prefix once, then extends it to 128; greedy tokens equal
    JAX's and the port's uncached run."""
    import dataclasses

    jcfg, tcfg, jparams = weights
    jcfg = dataclasses.replace(jcfg, max_seq_len=512)
    tcfg = dataclasses.replace(tcfg, max_seq_len=512)
    fused = jax_fuse(jparams)
    jl = JaxLlama(fused, JaxByteTokenizer(), jcfg)
    tl = Llama(llama_from_numpy(fused), ByteTokenizer(), tcfg)
    for prompts in PREFIX_BATCHES:
        want = jl.text_completion(prompts, temperature=0.0, max_gen_len=8, use_prefix_cache=True)
        got = tl.text_completion(prompts, temperature=0.0, max_gen_len=8, use_prefix_cache=True)
        plain = tl.text_completion(prompts, temperature=0.0, max_gen_len=8)
        assert got == want == plain
    assert (tl.prefix_rebuilds, tl.prefix_extends) == (jl.prefix_rebuilds, jl.prefix_extends)
    assert (tl.prefix_rebuilds, tl.prefix_extends) == (1, 1)


def test_prefix_extension_at_the_cache_end(weights):
    """max_seq_len 256: extending the 64-token prefix prefills a chunk
    that would run past the cache. The port stops the chunk at the cache's
    end and matches its uncached run (the JAX package clamps the chunk's
    start there and does not: ROADMAP Queue 3)."""
    import dataclasses

    _, tcfg, jparams = weights
    tcfg = dataclasses.replace(tcfg, max_seq_len=256)
    tl = Llama(llama_from_numpy(jax_fuse(jparams)), ByteTokenizer(), tcfg)
    for prompts in PREFIX_BATCHES:
        got = tl.text_completion(prompts, temperature=0.0, max_gen_len=8, use_prefix_cache=True)
        assert got == tl.text_completion(prompts, temperature=0.0, max_gen_len=8)
    assert tl.prefix_extends == 1


def test_top_p_sampling_same_draws_as_jax():
    """Feed both samplers the same uniforms: the draws jax.random.categorical
    makes from its key (Gumbel noise from U[tiny, 1))."""
    rng = np.random.default_rng(4)
    for trial in range(5):
        logits = rng.normal(0, 2, (4, 50)).astype(np.float32)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / 0.7, axis=-1))
        key = jax.random.PRNGKey(trial)
        want = jax_sample_top_p(jnp.asarray(probs), 0.9, key)
        u = jax.random.uniform(key, probs.shape, jnp.float32,
                               minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
        got = sample_top_p(t(probs), 0.9, t(np.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
