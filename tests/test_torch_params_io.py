"""Direct save and restore of LLaMA trees (checkpoint/params_io.py), port
against prego_tpu's Orbax cache (checkpoint/orbax_io.py):

  * bf16/f32 and int8 trees, fused or not, with and without the int8 x
    int8 marker, round trip bit for bit; the file is a standard safetensors
    file (``safetensors.torch`` reads the same tensors);
  * the port's int8 restore equals orbax_io.load_llama_params(quantized=
    True) on the same tree;
  * TorchLlamaLLM(orbax_dir=) follows the JAX adapter's flow in each
    branch, counted by the calls of the converter and the quantizer, and
    completes as JaxLlamaLLM(orbax_dir=) does; int8x8 writes nothing;
  * a directory Orbax wrote, a layout or config that differs, and a
    directory without a manifest are refused."""


from dataclasses import replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from prego_tpu.anticipation.llm import JaxLlamaLLM
from prego_tpu.checkpoint import orbax_io
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config as jax_tiny_config
from prego_tpu.models.llama.model import fuse_projections as jax_fuse
from prego_tpu.models.llama.model import quantize_params as jax_quantize
from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
from prego_tpu_torch.checkpoint import convert, params_io
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, to_numpy
from prego_tpu_torch.models.llama import model, tiny_test_config
from prego_tpu_torch.models.llama.model import (
    fuse_projections, init_params, init_params_quantized, quantize_params,
)
from tests.test_torch_convert import meta_state, write_meta_dir

CFG = tiny_test_config(vocab_size=258)
JCFG = jax_tiny_config(vocab_size=258)


def _flat(tree):
    return params_io.flat_tensors(tree)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), k


def _tree(kind, fused, dtype):
    gen = torch.Generator().manual_seed(3)
    if kind == "float":
        p = init_params(CFG, gen, dtype=dtype)
        return fuse_projections(p) if fused else p
    if kind == "int8_drawn":
        return init_params_quantized(CFG, gen, fused=fused, dtype=dtype)
    p = init_params(CFG, gen, dtype=dtype)
    return quantize_params(fuse_projections(p) if fused else p, activations=kind == "int8x8")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["float", "int8", "int8x8", "int8_drawn"])
def test_round_trip_bit_for_bit(tmp_path, kind, fused, dtype):
    params = _tree(kind, fused, dtype)
    quantized = kind != "float"
    params_io.save_llama_params(str(tmp_path / "c"), params, CFG)
    got = params_io.load_llama_params(str(tmp_path / "c"), CFG, device="cpu", dtype=dtype,
                                      quantized=quantized, fused=fused,
                                      activations=kind == "int8x8")
    _assert_trees_equal(got, params)
    if quantized:
        leaf = got["layers"][0]["attention"]["wqkv" if fused else "wq"]
        assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.float32
        assert ("act" in leaf) == (kind == "int8x8")
    manifest = params_io.read_manifest(str(tmp_path / "c"))
    assert (manifest["quantized"], manifest["fused"], manifest["activations"]) == (
        quantized, fused, kind == "int8x8")
    # a standard safetensors file: the reference reader sees the same tensors
    st = pytest.importorskip("safetensors.torch")
    ref = st.load_file(str(tmp_path / "c" / params_io.WEIGHTS))
    flat = _flat(params)
    assert ref.keys() == flat.keys()
    assert all(torch.equal(_bits(ref[k]), _bits(flat[k])) for k in flat)


def test_restore_casts_float_leaves_only(tmp_path):
    params = _tree("int8", True, torch.bfloat16)
    params_io.save_llama_params(str(tmp_path / "c"), params)
    got = params_io.load_llama_params(str(tmp_path / "c"), CFG, device="cpu",
                                      dtype=torch.float32, quantized=True)
    assert got["tok_embeddings"].dtype == torch.float32
    assert torch.equal(got["tok_embeddings"], params["tok_embeddings"].float())
    assert got["output"]["q"].dtype == torch.int8 and got["output"]["s"].dtype == torch.float32


def test_int8_restore_equals_orbax(tmp_path):
    """The same fused int8 tree through the JAX package's Orbax save and
    quantized restore, and through the port's: every leaf equal."""
    jp = jax_quantize(jax_fuse(jax_init_params(JCFG, jax.random.PRNGKey(2),
                                               dtype=jnp.float32)))
    orbax_io.save_llama_params(str(tmp_path / "orbax"), jp)
    want = orbax_io.load_llama_params(str(tmp_path / "orbax"), JCFG, quantized=True,
                                      fused=True, dtype=jnp.float32)
    params_io.save_llama_params(str(tmp_path / "port"),
                                llama_from_numpy(jax.tree.map(np.asarray, jp)), CFG)
    got = params_io.load_llama_params(str(tmp_path / "port"), CFG, device="cpu",
                                      dtype=torch.float32, quantized=True)
    wflat = _flat(jax.tree.map(np.asarray, want))
    gflat = _flat(got)
    assert gflat.keys() == wflat.keys()
    for k, w in wflat.items():
        g = to_numpy(gflat[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k


def test_bf16_restore_equals_orbax(tmp_path):
    jp = jax_init_params(JCFG, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    orbax_io.save_llama_params(str(tmp_path / "orbax"), jp)
    want = jax.tree.map(np.asarray, orbax_io.load_llama_params(str(tmp_path / "orbax"), JCFG))
    params_io.save_llama_params(str(tmp_path / "port"),
                                llama_from_numpy(jax.tree.map(np.asarray, jp)), CFG)
    got = params_io.load_llama_params(str(tmp_path / "port"), CFG, device="cpu")
    for k, w in _flat(want).items():
        g = to_numpy(_flat(got)[k])
        assert g.dtype == w.dtype == ml_dtypes.bfloat16
        assert np.array_equal(g.view(np.uint16), w.view(np.uint16)), k


def test_an_orbax_directory_is_refused(tmp_path):
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    orbax_io.save_llama_params(str(tmp_path / "orbax"), jp)
    with pytest.raises(ValueError, match="Orbax checkpoint"):
        params_io.load_llama_params(str(tmp_path / "orbax"), CFG, device="cpu")
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        params_io.load_llama_params(str(tmp_path), CFG, device="cpu")


def test_layout_and_config_mismatches_are_refused(tmp_path):
    path = str(tmp_path / "c")
    params_io.save_llama_params(path, _tree("int8", True, torch.float32), CFG)
    with pytest.raises(ValueError, match="layout"):
        params_io.load_llama_params(path, CFG, device="cpu")  # bf16 asked of an int8 tree
    with pytest.raises(ValueError, match="layout"):
        params_io.load_llama_params(path, CFG, device="cpu", quantized=True, activations=True)
    other = replace(CFG, multiple_of=32)  # another FFN width
    with pytest.raises(ValueError, match="another config"):
        params_io.load_llama_params(path, other, device="cpu", quantized=True)
    # without a stored config, the tensors' shapes are checked
    params_io.save_llama_params(path, _tree("int8", True, torch.float32))
    with pytest.raises(ValueError, match="w13.q is I8"):
        params_io.load_llama_params(path, other, device="cpu", quantized=True)
    # the vocabulary is the stored table's, whatever the config says
    got = params_io.load_llama_params(path, replace(CFG, vocab_size=100), device="cpu",
                                      quantized=True)
    assert got["tok_embeddings"].shape == (258, CFG.dim)


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    params_io.save_llama_params(str(tmp_path / "c"), _tree("float", False, torch.float32), CFG)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        params_io.load_llama_params(str(tmp_path / "c"), CFG)


# ---- TorchLlamaLLM(orbax_dir=): the JAX adapter's flow ----

@pytest.fixture(scope="module")
def meta_dir(tmp_path_factory):
    tree = jax.tree.map(np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(11),
                                                    dtype=jnp.float32))
    d = tmp_path_factory.mktemp("meta") / "llama-tiny"
    write_meta_dir(d, meta_state(llama_from_numpy(tree)), 2, CFG)
    return str(d)


@pytest.fixture
def calls(monkeypatch):
    """Counts of the converter's and the quantizer's calls."""
    counts = {"convert": 0, "quantize": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(convert, "convert_meta_checkpoint",
                        counting("convert", convert.convert_meta_checkpoint))
    monkeypatch.setattr(model, "quantize_params", counting("quantize", model.quantize_params))
    return counts


def _build(meta_dir, orbax_dir, quantize, calls):
    before = dict(calls)
    llm = TorchLlamaLLM(ckpt_dir=meta_dir, tokenizer_path="byte", max_seq_len=128,
                        max_batch_size=4, device="cpu", orbax_dir=str(orbax_dir),
                        quantize=quantize)
    return llm, {k: calls[k] - before[k] for k in calls}


PROMPTS = ["Sequence: 1, 2, 3\nNext:\n", "abc"]


def _complete(llm):
    return llm.text_completion(PROMPTS, max_gen_len=6, temperature=0.0)


def test_flow_bf16_cache(meta_dir, tmp_path, calls):
    """Absent, quantize off: convert, then save the unfused tree. Present,
    quantize off: restore (no conversion). Present (bf16), int8: restore,
    then quantize; the cache is left as it is."""
    cache = tmp_path / "cache"
    first, n = _build(meta_dir, cache, False, calls)
    assert n == {"convert": 1, "quantize": 0}
    m = params_io.read_manifest(str(cache))
    assert (m["quantized"], m["fused"]) == (False, False)
    stamp = (cache / params_io.WEIGHTS).stat().st_mtime_ns
    second, n = _build(meta_dir, cache, False, calls)
    assert n == {"convert": 0, "quantize": 0}
    _assert_trees_equal(second.llama.params, first.llama.params)
    assert _complete(second) == _complete(first)
    q, n = _build(meta_dir, cache, "int8", calls)
    assert n == {"convert": 0, "quantize": 1}
    assert params_io.read_manifest(str(cache))["quantized"] is False
    assert (cache / params_io.WEIGHTS).stat().st_mtime_ns == stamp
    plain = TorchLlamaLLM(ckpt_dir=meta_dir, tokenizer_path="byte", max_seq_len=128,
                          max_batch_size=4, device="cpu", quantize="int8")
    _assert_trees_equal(q.llama.params, plain.llama.params)


def test_flow_int8_cache(meta_dir, tmp_path, calls):
    """Absent, int8: convert, quantize, save the fused int8 tree. Present
    (int8), int8: the int8 tree restored directly, neither converter nor
    quantizer runs, and completions are the same. Present (int8), quantize
    off or int8x8: refused, as the JAX adapter's restore fails there."""
    cache = tmp_path / "cache"
    first, n = _build(meta_dir, cache, "int8", calls)
    assert n == {"convert": 1, "quantize": 1}
    m = params_io.read_manifest(str(cache))
    assert (m["quantized"], m["fused"], m["activations"]) == (True, True, False)
    second, n = _build(meta_dir, cache, "int8", calls)
    assert n == {"convert": 0, "quantize": 0}
    _assert_trees_equal(second.llama.params, first.llama.params)
    assert second.llama.params["output"]["q"].dtype == torch.int8
    assert _complete(second) == _complete(first)
    for mode in (False, "int8x8"):
        with pytest.raises(ValueError, match="layout"):
            _build(meta_dir, cache, mode, calls)


def test_flow_with_a_table_larger_than_the_tokenizer(tmp_path, calls):
    """A checkpoint whose embedding table has more rows than the byte
    tokenizer's vocabulary (the converter takes the table as stored): the
    cache written by the first build restores in the second."""
    cfg = replace(CFG, vocab_size=300)
    d = write_meta_dir(tmp_path / "meta", meta_state(init_params(
        cfg, torch.Generator().manual_seed(8), dtype=torch.float32)), 1, cfg)
    first, n1 = _build(str(d), tmp_path / "cache", "int8", calls)
    second, n2 = _build(str(d), tmp_path / "cache", "int8", calls)
    assert (n1, n2) == ({"convert": 1, "quantize": 1}, {"convert": 0, "quantize": 0})
    assert second.llama.params["tok_embeddings"].shape == (300, CFG.dim)
    _assert_trees_equal(second.llama.params, first.llama.params)
    assert _complete(second) == _complete(first)


def test_flow_int8x8_writes_nothing(meta_dir, tmp_path, calls):
    cache = tmp_path / "cache"
    llm, n = _build(meta_dir, cache, "int8x8", calls)
    assert n == {"convert": 1, "quantize": 1}
    assert not cache.exists()
    assert "act" in llm.llama.params["layers"][0]["attention"]["wqkv"]


def test_flow_refuses_an_orbax_directory(meta_dir, tmp_path, calls):
    orbax_io.save_llama_params(str(tmp_path / "orbax"),
                               jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    for mode in (False, "int8"):
        with pytest.raises(ValueError, match="Orbax checkpoint"):
            _build(meta_dir, tmp_path / "orbax", mode, calls)
    assert calls == {"convert": 0, "quantize": 0}


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_flow_completes_as_the_jax_adapter(meta_dir, tmp_path, calls, quantize):
    """JaxLlamaLLM(orbax_dir=) and TorchLlamaLLM(orbax_dir=) on the same
    Meta directory, each built twice (write, then restore): the same greedy
    completions every time."""
    want = []
    for _ in range(2):
        jllm = JaxLlamaLLM(ckpt_dir=meta_dir, tokenizer_path="byte", max_seq_len=128,
                           max_batch_size=4, tp=1, dtype=jnp.float32,
                           orbax_dir=str(tmp_path / "jax_cache"), quantize=quantize)
        want.append(_complete(jllm))
    assert want[0] == want[1]
    for i in range(2):
        llm, n = _build(meta_dir, tmp_path / "port_cache", quantize, calls)
        assert n["convert"] == 1 - i
        assert _complete(llm) == want[0]
