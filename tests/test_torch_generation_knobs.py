"""The generation knobs of the port's Llama, as the JAX Llama has them:
the PREGO_SAMPLE_SEED environment variable seeds the sampler, and the
constructor takes pad_to_multiple and prefix_cache_slots (in the JAX
argument order and with its defaults), on a tiny config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
from prego_tpu.models.llama import Llama as JaxLlama
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama import generation

PROMPTS = ["step one; step two; " * 2 + "a", "step one; step two; " * 2 + "b, c"]
# three shared contexts of 64+ tokens each, so each batch builds its own prefix
CONTEXTS = [[f"{w} context line; " * 5 + "1\n", f"{w} context line; " * 5 + "1, 2\n"]
            for w in ("first", "second", "third")]


@pytest.fixture(scope="module")
def weights():
    jcfg = tiny_test_config(vocab_size=258)
    tcfg = LlamaConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    jp = jax.tree.map(np.asarray, jax_fuse(jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32)))
    return jcfg, tcfg, jp


def _sampled(tcfg, jp, monkeypatch, seed=None):
    if seed is None:
        monkeypatch.delenv("PREGO_SAMPLE_SEED", raising=False)
    else:
        monkeypatch.setenv("PREGO_SAMPLE_SEED", seed)
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg)
    return [r["generation"] for r in tl.text_completion(PROMPTS, temperature=1.0, top_p=1.0,
                                                        max_gen_len=24)]


def test_sample_seed_one_is_the_default(weights, monkeypatch):
    _, tcfg, jp = weights
    assert _sampled(tcfg, jp, monkeypatch, "1") == _sampled(tcfg, jp, monkeypatch)


def test_another_sample_seed_changes_a_sampled_run(weights, monkeypatch):
    _, tcfg, jp = weights
    two = _sampled(tcfg, jp, monkeypatch, "2")
    assert two != _sampled(tcfg, jp, monkeypatch)
    assert two == _sampled(tcfg, jp, monkeypatch, "2")  # and is itself reproducible


def test_one_prefix_slot_evicts_the_first_prefix(weights):
    _, tcfg, jp = weights
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, prefix_cache_slots=1)
    tl.text_completion(CONTEXTS[0], temperature=0.0, max_gen_len=4, use_prefix_cache=True)
    (first,) = tl._prefix_caches
    tl.text_completion(CONTEXTS[1], temperature=0.0, max_gen_len=4, use_prefix_cache=True)
    assert len(tl._prefix_caches) == 1 and first not in tl._prefix_caches
    assert tl.prefix_rebuilds == 2
    # floored at 1, as the JAX Llama does
    assert Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, prefix_cache_slots=0
                 ).prefix_cache_slots == 1


@pytest.mark.parametrize("pad_to_multiple,want", [(64, 64), (16, 32), (5, 25)])
def test_pad_to_multiple_sets_the_token_buffer(weights, monkeypatch, pad_to_multiple, want):
    """A prompt of 17 tokens (bos + 16 bytes) and 4 new ones: 21 positions,
    rounded up to the multiple (and cut at max_seq_len)."""
    _, tcfg, jp = weights
    widths = []
    real = generation.forward

    def recording(params, tokens, *args, **kwargs):
        widths.append(tokens.shape[1])
        return real(params, tokens, *args, **kwargs)

    monkeypatch.setattr(generation, "forward", recording)
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, pad_to_multiple=pad_to_multiple)
    assert tl.pad_to_multiple == pad_to_multiple
    tl.text_completion(["x" * 16], temperature=0.0, max_gen_len=4)
    assert widths[0] == want  # the prefill takes the whole buffer


def test_constructor_takes_the_jax_arguments_in_order(weights):
    _, tcfg, jp = weights
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, 32, True, 3)
    assert (tl.pad_to_multiple, tl.kv_quant, tl.prefix_cache_slots) == (32, True, 3)
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg)
    assert (tl.pad_to_multiple, tl.kv_quant, tl.prefix_cache_slots) == (64, False, 4)


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_prefix_count_matches_the_jax_llama(weights, slots):
    """Given the same constructor arguments, the JAX Llama and the port's
    keep the same prefixes after the same batches, and answer alike."""
    jcfg, tcfg, jp = weights
    jl = JaxLlama(jp, JaxByteTokenizer(), jcfg, pad_to_multiple=32, prefix_cache_slots=slots)
    tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, pad_to_multiple=32,
               prefix_cache_slots=slots)
    for prompts in CONTEXTS:
        want = jl.text_completion(prompts, temperature=0.0, max_gen_len=4, use_prefix_cache=True)
        got = tl.text_completion(prompts, temperature=0.0, max_gen_len=4, use_prefix_cache=True)
        assert got == want
        assert list(tl._prefix_caches) == list(jl._prefix_caches)
    assert len(tl._prefix_caches) == min(slots, len(CONTEXTS))
    assert (tl.prefix_rebuilds, tl.prefix_extends) == (jl.prefix_rebuilds, jl.prefix_extends)
