"""The int8 decode fusion gates on the port's LLaMA: each setting of
PREGO_FUSED_DENSE_Q8 and PREGO_FUSED_FFN_Q8 (with PREGO_FUSED_LAYER)
reaches the kernels the JAX package's dispatch reaches (K9 with its norm
prologue for wqkv and the lm-head, K9 with its residual epilogue for wo,
K7q for the FFN sub-layer, or the unfused K4 sequence), and its decode
steps match prego_tpu's forward on the CPU with the same gates forced on
and its K9 and K7q in interpret mode, on a weight-only int8 tree."""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import prego_tpu.models.llama.model as jax_model
import prego_tpu.ops.fused_dense as jax_fd
import prego_tpu.ops.fused_ffn as jax_ffn
from prego_tpu.models.llama import forward as jax_forward
from prego_tpu.models.llama import init_cache as jax_init_cache
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama.config import LlamaConfig as JaxLlamaConfig
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu.models.llama.model import quantize_params as jax_quantize
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import LlamaConfig
from prego_tpu_torch.models.llama.model import (
    forward, fusion_gates, init_cache, mark_activations,
)
from prego_tpu_torch.ops import decode_attention as k2
from prego_tpu_torch.ops import decode_attention_q8 as k3
from prego_tpu_torch.ops import fused_dense as k9
from prego_tpu_torch.ops import fused_ffn as k7
from prego_tpu_torch.ops import quant
from tests.torch_parity import n, t

# f32 activations on both sides; K9 and K7q's plain versions and the JAX
# interpret kernels round the same values to bf16 and sum exact products
# in f32 in another order, so the logits differ by the summation order
# over 2 layers of width 128 (measured 4.8e-7 at max |logit| 3.1): the bar
# of test_torch_llama_quant.py's int8 forward
TOL = dict(rtol=1e-4, atol=1e-4)
GATES = ("PREGO_FUSED_FFN", "PREGO_FUSED_ATTN_WO", "PREGO_FUSED_LAYER", "PREGO_FUSED_CACHE_UPD",
         "PREGO_FUSED_DENSE_Q8", "PREGO_FUSED_FFN_Q8")
BOTH = {"PREGO_FUSED_DENSE_Q8": "1", "PREGO_FUSED_FFN_Q8": "1"}
SETTINGS = {
    "off": {},
    "dense_q8": {"PREGO_FUSED_DENSE_Q8": "1"},
    "ffn_q8": {"PREGO_FUSED_FFN_Q8": "1"},
    "both": BOTH,
    "both_layer_off": {**BOTH, "PREGO_FUSED_LAYER": "0"},  # K7q needs the layer gate
}
N_LAYERS = 2


def reached(setting, attention="K2"):
    """What one decode step reaches (the JAX package's branches), by kernel."""
    dense = setting in ("dense_q8", "both", "both_layer_off")
    ffn = setting in ("ffn_q8", "both")
    L = N_LAYERS
    counts = {attention: L}
    if dense:  # norm + wqkv and wo + residual a layer, norm + lm-head once
        counts.update({"K9-norm": L + 1, "K9-res": L})
    if ffn:
        counts["K7q"] = L
    k4 = (0 if dense else 2 * L + 1) + (0 if ffn else 2 * L)  # the projections left to K4
    if k4:
        counts["K4"] = k4
    return counts


def _config(**kw):
    # hd 64 (dim 128, 2 query heads) over 1 kv head: R = 2
    fields = dict(dim=128, n_layers=N_LAYERS, n_heads=2, n_kv_heads=1, vocab_size=258,
                  multiple_of=16, norm_eps=1e-5, max_batch_size=4, max_seq_len=128)
    fields.update(kw)
    return JaxLlamaConfig(**fields), LlamaConfig(**fields)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _config()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, tcfg, jax.tree.map(np.asarray, jax_quantize(jax_fuse(jp))), jp


def _set(monkeypatch, setting):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    for g, v in SETTINGS[setting].items():
        monkeypatch.setenv(g, v)


def _jax_gates_on_cpu(monkeypatch):
    """The JAX package's int8 gates read the same variables but also ask
    for a TPU backend; here they read the variables alone, and its K9 and
    K7q run in interpret mode. Returns the count of their calls."""
    monkeypatch.setattr(jax_model, "_fused_dense_q8_supported",
                        lambda: os.environ.get("PREGO_FUSED_DENSE_Q8", "0") == "1")
    monkeypatch.setattr(jax_model, "_fused_ffn_q8_supported",
                        lambda: os.environ.get("PREGO_FUSED_FFN_Q8", "0") == "1")
    calls = collections.Counter()

    def interpret(mod, name, key):
        fn = getattr(mod, name)

        def run(*args, **kwargs):
            calls[key(kwargs) if callable(key) else key] += 1
            return fn(*args, **kwargs, interpret=True)

        monkeypatch.setattr(mod, name, run)

    interpret(jax_fd, "fused_dense_q8",
              lambda kw: "K9-res" if kw.get("residual") is not None else "K9-norm")
    interpret(jax_ffn, "fused_ffn_block_q8", "K7q")
    return calls


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
    wrap(quant, "int8_matmul_reference", "K4")
    wrap(quant, "int8xint8_matmul_reference", "K5")
    wrap(k9, "fused_dense_q8_reference",
         lambda a, kw: "K9-res" if kw.get("residual") is not None else "K9-norm")
    wrap(k7, "fused_ffn_block_q8_reference", "K7q")
    return counts


def _decode_counts(monkeypatch, tp, tcfg, kv_quant=False, prompt=((1, 2, 3), (4, 5, 6))):
    cache = init_cache(tcfg, len(prompt), torch.float32, quantized=kv_quant)
    forward(tp, torch.tensor(prompt), 0, cache, tcfg)
    counts = _count_plain_versions(monkeypatch)
    forward(tp, torch.tensor([[7]] * len(prompt)), len(prompt[0]), cache, tcfg)
    return dict(counts)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_decode_matches_jax_forward(weights, monkeypatch, setting):
    jcfg, tcfg, jp, _ = weights
    _set(monkeypatch, setting)
    jax_calls = _jax_gates_on_cpu(monkeypatch)
    tp = llama_from_numpy(jp)
    B = 2
    toks = np.random.default_rng(1).integers(0, 256, (B, 10)).astype(np.int32)
    jl, jc = jax_forward(jp, jnp.asarray(toks[:, :6]), jnp.int32(0),
                         jax_init_cache(jcfg, B, jnp.float32), jcfg)
    tl, tc = forward(tp, t(toks[:, :6]).long(), 0, init_cache(tcfg, B, torch.float32), tcfg)
    np.testing.assert_allclose(n(tl), n(jl), **TOL)  # 12 rows: the lm-head takes K9 here too
    jax_calls.clear()
    for i in range(6, 10):  # decode steps across the fused branches
        jl, jc = jax_forward(jp, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i), jc, jcfg)
        tl, tc = forward(tp, t(toks[:, i : i + 1]).long(), i, tc, tcfg)
        np.testing.assert_allclose(n(tl), n(jl), **TOL)
    # the JAX forward took its fused branches: 4 steps of the port's counts
    want = {k: 4 * v for k, v in reached(setting).items() if k in ("K9-norm", "K9-res", "K7q")}
    assert dict(jax_calls) == want


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_dispatch_reaches_the_jax_packages_kernels(weights, monkeypatch, setting, kv_quant):
    """Per decode step: K9-norm and K9-res once a layer and K9-norm once
    more for the head (dense gate), K7q once a layer (FFN and layer gates);
    over an int8 KV cache K3 runs in K2's place."""
    _, tcfg, jp, _ = weights
    _set(monkeypatch, setting)
    got = _decode_counts(monkeypatch, llama_from_numpy(jp), tcfg, kv_quant)
    assert got == reached(setting, "K3" if kv_quant else "K2")


@pytest.mark.parametrize("B,S,fused", [(2, 32, True), (1, 64, True), (2, 33, False),
                                       (1, 65, False)])
def test_lm_head_takes_k9_up_to_64_rows(weights, monkeypatch, B, S, fused):
    """B * S <= 64, not S == 1: a prefill of up to 64 rows ends in K9 (its
    plain version computes the unfused norm and K4, bit for bit)."""
    _, tcfg, jp, _ = weights
    tp = llama_from_numpy(jp)
    toks = torch.from_numpy(np.random.default_rng(B * S).integers(0, 256, (B, S)))
    _set(monkeypatch, "off")
    want, _ = forward(tp, toks, 0, init_cache(tcfg, B, torch.float32), tcfg)
    _set(monkeypatch, "both")
    counts = _count_plain_versions(monkeypatch)
    got, _ = forward(tp, toks, 0, init_cache(tcfg, B, torch.float32), tcfg)
    assert counts.get("K9-norm", 0) == int(fused)
    assert "K9-res" not in counts and "K7q" not in counts  # prefill rows: no layer site
    assert torch.equal(got, want)


def test_int8x8_trees_never_reach_k9_or_k7q(weights, monkeypatch):
    _, tcfg, jp, _ = weights
    _set(monkeypatch, "both")
    tp = mark_activations(llama_from_numpy(jp), True)
    assert _decode_counts(monkeypatch, tp, tcfg) == {"K2": N_LAYERS, "K5": 4 * N_LAYERS + 1}


def test_bf16_leaves_never_reach_k9_or_k7q(weights, monkeypatch):
    """A bf16 tree with both int8 gates on runs the bf16 dispatch (here the
    default K7a, and K2 for a wo past none of K8's conditions but its gate)."""
    _, tcfg, _, jparams = weights
    _set(monkeypatch, "both")
    monkeypatch.setenv("PREGO_FUSED_ATTN_WO", "0")
    tp = llama_from_numpy(jax.tree.map(np.asarray, jax_fuse(jparams)))
    counts = _decode_counts(monkeypatch, tp, tcfg)
    assert counts == {"K2": N_LAYERS}  # K7a's plain version is not counted here
    assert fusion_gates().dense_q8 and fusion_gates().ffn_q8


def test_unfused_layout_keeps_the_jax_sites(weights, monkeypatch):
    """wq / wk / wv and w1 / w3 leaves: no norm + qkv site and no K7q, as
    in the JAX package, whose wo + residual and lm-head sites ask only for
    a weight-only int8 wo and output."""
    _, tcfg, _, jparams = weights
    _set(monkeypatch, "both")
    tp = llama_from_numpy(jax.tree.map(np.asarray, jax_quantize(jparams)))
    assert _decode_counts(monkeypatch, tp, tcfg) == {
        "K2": N_LAYERS, "K9-res": N_LAYERS, "K9-norm": 1, "K4": 6 * N_LAYERS}


def test_gates_default_to_off(weights, monkeypatch):
    _, tcfg, jp, _ = weights
    _set(monkeypatch, "off")
    gates = fusion_gates()
    assert not gates.dense_q8 and not gates.ffn_q8
    for value in ("0", "true", "yes", "2"):  # on only when it equals "1"
        monkeypatch.setenv("PREGO_FUSED_DENSE_Q8", value)
        monkeypatch.setenv("PREGO_FUSED_FFN_Q8", value)
        assert not fusion_gates().dense_q8 and not fusion_gates().ffn_q8
    _set(monkeypatch, "off")
    assert _decode_counts(monkeypatch, llama_from_numpy(jp), tcfg, kv_quant=True) == reached(
        "off", "K3")
