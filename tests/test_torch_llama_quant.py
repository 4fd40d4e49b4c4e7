"""Quantized LLaMA serving parity on a tiny config: the port's forward
under --quantize int8 / int8x8 and --kv_quant against prego_tpu's, with
the JAX parameters handed over through the bridge; the direct int8 init,
quantize_params, the bridge's int8 trees and prefix-cached generation over
an int8 KV cache."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama import forward as jax_forward
from prego_tpu.models.llama import init_cache as jax_init_cache
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu.models.llama.model import init_params_quantized as jax_init_quantized
from prego_tpu.models.llama.model import quantize_params as jax_quantize
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, to_numpy_tree
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama.model import (
    forward, fuse_projections, init_cache, init_params_quantized, quantize_params,
)
from tests.torch_parity import n, t

# f32 activations on both sides; the plain K4 and K5 are the JAX
# references (exact products, f32 sums in another order; exact int32
# sums), so logits differ by the summation order over 2 layers of width 64
TIGHT = dict(rtol=1e-4, atol=1e-4)
# int8 KV cache: the JAX CPU path dequantizes the cache for an f32 einsum,
# while the port's plain K3 rounds q and p * v_scale to bf16 (2^-9 each)
# as the kernel does. The bar of tests/test_llama.py's kv_quant test:
# RMS drift under 3% of the logits' spread, and the same greedy token
# wherever JAX's top-2 margin exceeds a quarter of that spread
KV_RMS, KV_MARGIN = 0.03, 0.25


def _config():
    c = tiny_test_config(vocab_size=258)
    return c, LlamaConfig(**{f: getattr(c, f) for f in c.__dataclass_fields__})


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _config()
    jparams = jax_fuse(jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    return jcfg, tcfg, jparams


def _rollout(fwd, params, cache, tokens):
    """A 5-token prefill and then one decode step per remaining token."""
    outs = []
    logits, cache = fwd(params, tokens[:, :5], 0, cache)
    outs.append(n(logits))
    for i in range(5, tokens.shape[1]):
        logits, cache = fwd(params, tokens[:, i : i + 1], i, cache)
        outs.append(n(logits))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("quantize,kv_quant", [("int8", False), ("int8x8", False),
                                               ("int8", True), (False, True)])
def test_forward_matches_jax(weights, quantize, kv_quant):
    jcfg, tcfg, jparams = weights
    jp = jax_quantize(jparams, activations=quantize == "int8x8") if quantize else jparams
    jp = jax.tree.map(np.asarray, jp)
    tp = llama_from_numpy(jp)
    B = 2
    tokens = np.random.default_rng(1).integers(0, 256, (B, 12)).astype(np.int32)
    want = _rollout(
        lambda p, tk, pos, c: jax_forward(p, jnp.asarray(tk), jnp.int32(pos), c, jcfg),
        jp, jax_init_cache(jcfg, B, jnp.float32, quantized=kv_quant), tokens)
    got = _rollout(
        lambda p, tk, pos, c: forward(p, t(tk).long(), pos, c, tcfg),
        tp, init_cache(tcfg, B, torch.float32, quantized=kv_quant), tokens)
    if not kv_quant:
        np.testing.assert_allclose(got, want, **TIGHT)
        return
    np.testing.assert_allclose(got[:, :5], want[:, :5], **TIGHT)  # prefill: same dequantized einsum
    spread = np.std(want)
    assert np.sqrt(np.mean((got - want) ** 2)) / spread < KV_RMS
    srt = np.sort(want, axis=-1)
    clear = (srt[..., -1] - srt[..., -2]) / spread > KV_MARGIN
    assert clear.sum() >= 5  # the greedy check has positions to hold
    assert np.all(got.argmax(-1)[clear] == want.argmax(-1)[clear])


def test_quantize_params_matches_jax_and_composes_with_fusion(weights):
    jcfg, tcfg, jparams = weights
    want = jax.tree.map(np.asarray, jax_quantize(jparams, activations=True))
    got = quantize_params(llama_from_numpy(jax.tree.map(np.asarray, jparams)), activations=True)
    assert jax.tree.structure(to_numpy_tree(got)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(to_numpy_tree(got)), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=2.0 ** -23, atol=0)  # scales within one ulp
    # per-column scales: fusing int8 leaves equals quantizing the fused weights
    unfused = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(2),
                                                       dtype=jnp.float32))
    a = fuse_projections(quantize_params(llama_from_numpy(unfused)))
    b = quantize_params(fuse_projections(llama_from_numpy(unfused)))
    for x, y in zip(jax.tree.leaves(to_numpy_tree(a)), jax.tree.leaves(to_numpy_tree(b))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("activations", [False, True])
def test_init_params_quantized_like_jax(fused, activations):
    jcfg, tcfg = _config()
    want = jax.tree.map(np.asarray, jax_init_quantized(
        jcfg, jax.random.PRNGKey(0), fused=fused, dtype=jnp.float32, activations=activations))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = init_params_quantized(tcfg, gen, fused=fused, dtype=torch.float32,
                                activations=activations)
    got_np = to_numpy_tree(got)
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
    # the effective weights q * s have init_params' RMS, 1/sqrt(d_in)
    layer = got["layers"][0]
    for leaf in [*layer["attention"].values(), *layer["feed_forward"].values(), got["output"]]:
        d_in = leaf["q"].shape[0]
        rms = float((leaf["q"].float() * leaf["s"]).pow(2).mean().sqrt())
        assert abs(rms * d_in ** 0.5 - 1) < 0.05
        assert int(leaf["q"].min()) >= -127 and ("act" in leaf) == activations
    # and it serves: the forward runs on the direct-int8 tree
    logits, _ = forward(got, torch.tensor([[1, 2, 3]]), 0, init_cache(tcfg, 1, torch.float32),
                        tcfg)
    assert torch.all(torch.isfinite(logits))


@pytest.mark.parametrize("source", ["quantize_params", "init_params_quantized"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("activations", [False, True])
def test_bridge_round_trips_int8_trees(source, fused, activations):
    jcfg, _ = _config()
    if source == "quantize_params":
        base = jax_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
        jp = jax_quantize(jax_fuse(base) if fused else base, activations=activations)
    else:
        jp = jax_init_quantized(jcfg, jax.random.PRNGKey(1), fused=fused, dtype=jnp.float32,
                                activations=activations)
    jp = jax.tree.map(np.asarray, jp)
    tp = llama_from_numpy(jp, dtype=torch.bfloat16)  # dtype applies outside q and s
    out = tp["layers"][0]["attention"]["wqkv" if fused else "wq"]
    assert out["q"].dtype == torch.int8 and out["s"].dtype == torch.float32
    assert ("act" in out) == activations and (out.get("act", ()) == ())
    assert tp["tok_embeddings"].dtype == torch.bfloat16
    back = to_numpy_tree(llama_from_numpy(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert back["layers"][1]["feed_forward"]["w2"].get("act", ()) == ()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


CTX = "context line; " * 5  # 70 bytes
PREFIX_BATCHES = [
    [CTX + "3, 1\n", CTX + "3, 1, 4\n"],  # shared prefix 64: built
    [CTX * 2 + "7\n", CTX * 2 + "7, 2\n"],  # prefix 128: extended from 64
    [CTX + "9\n"],  # prefix 64 again: an LRU hit
]


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_kv_quant_prefix_cached_generation_equals_uncached(weights, quantize):
    """Llama(kv_quant=True): the prefix LRU holds int8 caches (built,
    extended, cloned to the batch) and greedy output equals its own
    uncached run."""
    _, tcfg, jparams = weights
    tcfg = dataclasses.replace(tcfg, max_seq_len=512)
    params = llama_from_numpy(jax.tree.map(np.asarray, jparams))
    if quantize:
        params = quantize_params(params)
    tl = Llama(params, ByteTokenizer(), tcfg, kv_quant=True)
    for prompts in PREFIX_BATCHES:
        got = tl.text_completion(prompts, temperature=0.0, max_gen_len=8, use_prefix_cache=True)
        assert got == tl.text_completion(prompts, temperature=0.0, max_gen_len=8)
    assert (tl.prefix_rebuilds, tl.prefix_extends) == (1, 1)
    cache = next(iter(tl._prefix_caches.values()))
    assert cache["k"][0]["q"].dtype == torch.int8 and cache["v"][1]["s"].dtype == torch.float32
