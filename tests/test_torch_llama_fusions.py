"""The bf16 decode fusion gates on the port's LLaMA: each setting of
PREGO_FUSED_{ATTN_WO,LAYER,CACHE_UPD,FFN} reaches the kernels the JAX
package's dispatch reaches (K8 with and without its residual epilogue,
K8u, K7, K7a, or the unfused K2 sequence), and its decode steps match
prego_tpu's forward on the CPU (which runs the unfused sequence there),
at an hd-128 shape with grouped-query heads."""

import collections
import dataclasses

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
from prego_tpu.models.llama.config import LlamaConfig as JaxLlamaConfig
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama import model as port_model
from prego_tpu_torch.models.llama.model import (
    forward, fuse_projections, init_cache, init_params, quantize_params,
)
from prego_tpu_torch.ops import decode_attention as k2
from prego_tpu_torch.ops import decode_attention_q8 as k3
from prego_tpu_torch.ops import decode_attention_wo as k8
from prego_tpu_torch.ops import fused_ffn as k7
from tests.torch_parity import n, t

# f32 weights and activations on both sides; the fused plain versions run
# the unfused sequence's own ops, so logits differ only by summation order
# over 2 layers of width 256 (test_torch_llama.py's bar)
TOL = dict(rtol=1e-4, atol=1e-4)
GATES = ("PREGO_FUSED_FFN", "PREGO_FUSED_ATTN_WO", "PREGO_FUSED_LAYER", "PREGO_FUSED_CACHE_UPD")
SETTINGS = {
    "default": {},
    "attn_wo_off": {"PREGO_FUSED_ATTN_WO": "0"},
    "layer_off": {"PREGO_FUSED_LAYER": "0"},
    "cache_upd": {"PREGO_FUSED_CACHE_UPD": "1"},
    "ffn_off": {"PREGO_FUSED_FFN": "0"},
    "cache_upd_layer_off": {"PREGO_FUSED_CACHE_UPD": "1", "PREGO_FUSED_LAYER": "0"},
}
# what one decode layer reaches in each setting (the JAX package's branches)
REACHED = {
    "default": {"K8-res", "K7a"},
    "attn_wo_off": {"K2", "K7a"},
    "layer_off": {"K8", "K7"},
    "cache_upd": {"K8u", "K7a"},
    "ffn_off": {"K8-res"},
    "cache_upd_layer_off": {"K8", "K7"},  # K8u needs the layer gate too
}
N_LAYERS = 2


def _config(**kw):
    # hd 128 (dim 256, 2 query heads) over 1 kv head: R = 2
    fields = dict(dim=256, n_layers=N_LAYERS, n_heads=2, n_kv_heads=1, vocab_size=258,
                  multiple_of=16, norm_eps=1e-5, max_batch_size=4, max_seq_len=256)
    fields.update(kw)
    return JaxLlamaConfig(**fields), LlamaConfig(**fields)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _config()
    jp = jax.tree.map(np.asarray, jax_fuse(jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                           dtype=jnp.float32)))
    return jcfg, tcfg, jp


def _set(monkeypatch, setting):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    for g, v in SETTINGS[setting].items():
        monkeypatch.setenv(g, v)


def _count_plain_versions(monkeypatch):
    """Count the outermost plain kernel version each call reaches (on the
    CPU every wrapper runs its plain version)."""
    counts = collections.Counter()
    depth = [0]

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kwargs):
            if depth[0] == 0:
                counts[key(args, kwargs) if callable(key) else key] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(mod, name, counted)

    wrap(k2, "decode_attention_reference", "K2")
    wrap(k3, "decode_attention_q8_reference", "K3")
    wrap(k8, "decode_attention_wo_reference",
         lambda a, kw: "K8" if (a[5] if len(a) > 5 else kw.get("residual")) is None else "K8-res")
    wrap(k8, "decode_attention_wo_res_upd_reference", "K8u")
    wrap(k7, "fused_ffn_block_reference", "K7a")
    wrap(k7, "fused_ffn_reference", "K7")
    return counts


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_decode_matches_jax_forward(weights, monkeypatch, setting):
    jcfg, tcfg, jp = weights
    _set(monkeypatch, setting)
    tp = llama_from_numpy(jp)
    B = 2
    toks = np.random.default_rng(1).integers(0, 256, (B, 10)).astype(np.int32)
    jl, jc = jax_forward(jp, jnp.asarray(toks[:, :6]), jnp.int32(0),
                         jax_init_cache(jcfg, B, jnp.float32), jcfg)
    tl, tc = forward(tp, t(toks[:, :6]).long(), 0, init_cache(tcfg, B, torch.float32), tcfg)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)
    for i in range(6, 10):  # decode steps across the fused branches
        jl, jc = jax_forward(jp, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i), jc, jcfg)
        tl, tc = forward(tp, t(toks[:, i : i + 1]).long(), i, tc, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), **TOL)
    for key in ("k", "v"):  # the caches written (by K8u in place, or before K8)
        for layer in range(N_LAYERS):
            np.testing.assert_allclose(n(tc[key][layer]), n(jc[key][layer]), **TOL)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_dispatch_reaches_the_jax_packages_kernels(weights, monkeypatch, setting):
    _, tcfg, jp = weights
    _set(monkeypatch, setting)
    tp = llama_from_numpy(jp)
    cache = init_cache(tcfg, 2, torch.float32)
    forward(tp, torch.tensor([[1, 2, 3], [4, 5, 6]]), 0, cache, tcfg)  # prefill: no kernel
    counts = _count_plain_versions(monkeypatch)
    forward(tp, torch.tensor([[7], [8]]), 3, cache, tcfg)
    assert dict(counts) == {k: N_LAYERS for k in REACHED[setting]}


@pytest.mark.parametrize("tree", ["int8_kv_cache", "int8_weights"])
def test_dispatch_keeps_int8_paths(weights, monkeypatch, tree):
    """An int8 KV cache is tested first (K3 whatever the gates say); an
    int8 wo never takes K8 or K8u and int8 FFN weights run unfused."""
    _, tcfg, jp = weights
    _set(monkeypatch, "cache_upd")  # every bf16 fusion gate on
    tp = llama_from_numpy(jp)
    if tree == "int8_weights":
        tp = quantize_params(tp)
    cache = init_cache(tcfg, 2, torch.float32, quantized=tree == "int8_kv_cache")
    forward(tp, torch.tensor([[1, 2, 3], [4, 5, 6]]), 0, cache, tcfg)
    counts = _count_plain_versions(monkeypatch)
    forward(tp, torch.tensor([[7], [8]]), 3, cache, tcfg)
    want = {"K3", "K7a"} if tree == "int8_kv_cache" else {"K2"}
    assert dict(counts) == {k: N_LAYERS for k in want}


@pytest.mark.parametrize("dim,heads,fused", [(2048, 16, True), (4096, 32, False)])
def test_wo_size_cap(monkeypatch, dim, heads, fused):
    """The 4.5M-element cap on wo: the 1B width (2048^2 = 4.19M) takes K8,
    the 7B width (4096^2 = 16.8M) keeps K2 and the wo product, as the JAX
    package's gate does (one layer, a tiny FFN)."""
    _set(monkeypatch, "default")
    cfg = LlamaConfig(dim=dim, n_layers=1, n_heads=heads, n_kv_heads=heads // 8,
                      vocab_size=258, multiple_of=16, ffn_dim_multiplier=0.01,
                      max_batch_size=1, max_seq_len=64)
    gen = torch.Generator().manual_seed(0)
    params = fuse_projections(init_params(cfg, gen, dtype=torch.float32))
    counts = _count_plain_versions(monkeypatch)
    logits, _ = forward(params, torch.tensor([[5]]), 0, init_cache(cfg, 1, torch.float32), cfg)
    assert torch.all(torch.isfinite(logits))
    assert dict(counts) == ({"K8-res": 1, "K7a": 1} if fused else {"K2": 1, "K7a": 1})


def test_gates_are_read_once_per_forward(weights, monkeypatch):
    _, tcfg, jp = weights
    calls = []
    real = port_model.fusion_gates
    monkeypatch.setattr(port_model, "fusion_gates", lambda: calls.append(1) or real())
    tp = llama_from_numpy(jp)
    cache = init_cache(tcfg, 1, torch.float32)
    forward(tp, torch.tensor([[1, 2]]), 0, cache, tcfg)
    forward(tp, torch.tensor([[3]]), 2, cache, tcfg)
    assert len(calls) == 2  # not once per layer


PROMPTS = [
    ["context line; " * 5 + "3, 1\n", "context line; " * 5 + "3, 1, 4\n"],  # prefix 64 built
    ["context line; " * 10 + "7\n", "context line; " * 10 + "7, 2\n"],  # extended to 128
    ["context line; " * 5 + "9\n"],  # prefix 64 again: an LRU hit
]


def test_greedy_generation_equal_across_settings(weights, monkeypatch):
    """Greedy text, with and without the prefix LRU, is the same in every
    setting and equals the JAX package's; under K8u the LRU's cached
    prefixes stay as they were built (decode writes into clones)."""
    jcfg, tcfg, jp = weights
    jcfg = dataclasses.replace(jcfg, max_seq_len=512)
    tcfg = dataclasses.replace(tcfg, max_seq_len=512)
    want = [JaxLlama(jp, JaxByteTokenizer(), jcfg).text_completion(p, temperature=0.0,
                                                                     max_gen_len=6)
            for p in PROMPTS]
    for setting in SETTINGS:
        _set(monkeypatch, setting)
        tl = Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg)
        built = None
        for prompts, w in zip(PROMPTS, want):
            got = tl.text_completion(prompts, temperature=0.0, max_gen_len=6,
                                     use_prefix_cache=True)
            assert got == w, setting
            assert tl.text_completion(prompts, temperature=0.0, max_gen_len=6) == w, setting
            if built is None:  # the 64-token prefix, as the first batch built it
                built = {k: [c.clone() for c in v]
                         for k, v in next(iter(tl._prefix_caches.values())).items()}
        assert (tl.prefix_rebuilds, tl.prefix_extends) == (1, 1)
        first = tl._prefix_caches[min(tl._prefix_caches, key=len)]  # hit by the third batch
        for key in ("k", "v"):
            for a, b in zip(first[key], built[key]):
                assert torch.equal(a, b), setting
