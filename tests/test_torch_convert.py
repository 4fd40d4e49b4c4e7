"""The checkpoint converter, port against prego_tpu: Meta shards (1 and 2,
f32 and bf16) converted by the port equal the JAX converter's numpy output
bit for bit; an HF export of a local random ``LlamaForCausalLM`` (the
recipe of tests/test_hf_oracle.py, nothing downloaded) gives the logits of
transformers within 1e-4, prefill and incremental decode, from
``pytorch_model.bin`` and from ``.safetensors`` through the port's own
reader, which equals ``safetensors.numpy.load_file``; ``TorchLlamaLLM``
builds from a checkpoint directory and completes."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from prego_tpu.checkpoint.convert import convert_hf_checkpoint as jax_convert_hf
from prego_tpu.checkpoint.convert import convert_meta_checkpoint as jax_convert_meta
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama import tiny_test_config as jax_tiny_config
from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, to_numpy
from prego_tpu_torch.checkpoint.convert import (
    _inverse_hf_permute, convert_hf_checkpoint, convert_meta_checkpoint, load_safetensors,
)
from prego_tpu_torch.cli import anticipate
from prego_tpu_torch.models.llama import LlamaConfig, tiny_test_config
from prego_tpu_torch.models.llama.model import forward, init_cache

CFG = tiny_test_config(vocab_size=258)  # the byte tokenizer's vocabulary
JCFG = jax_tiny_config(vocab_size=258)
COLUMN, ROW = ("wq", "wk", "wv", "w1", "w3", "output"), ("wo", "w2")



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: under pytest-xdist each
    worker otherwise starts a thread per core, and the oversubscribed
    threads cost far more than they save at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def meta_state(params, dtype=torch.float32):
    """A port (unfused) tree as a Meta state dict, torch (out, in) layout."""
    c = lambda x: x.to(dtype).contiguous()
    sd = {"tok_embeddings.weight": c(params["tok_embeddings"]), "norm.weight": c(params["norm"]),
          "output.weight": c(params["output"].t()), "rope.freqs": torch.zeros(4)}
    for i, layer in enumerate(params["layers"]):
        for blk, sub in (("attention", "attention"), ("feed_forward", "feed_forward")):
            for k, w in layer[sub].items():
                sd[f"layers.{i}.{blk}.{k}.weight"] = c(w.t())
        sd[f"layers.{i}.attention_norm.weight"] = c(layer["attention_norm"])
        sd[f"layers.{i}.ffn_norm.weight"] = c(layer["ffn_norm"])
    return sd


def write_meta_dir(path, state, n_shards, config):
    """Shards split the fairscale way (column-parallel dim 0, row-parallel
    dim 1, the embedding dim 1, norms replicated) and a params.json."""
    shards = [dict() for _ in range(n_shards)]
    for key, w in state.items():
        leaf = key.rsplit(".", 2)[-2] if "." in key else key
        if key == "tok_embeddings.weight" or leaf in ROW:
            chunks = torch.chunk(w, n_shards, dim=1)
        elif leaf in COLUMN:
            chunks = torch.chunk(w, n_shards, dim=0)
        else:
            chunks = [w] * n_shards
        for s, ch in zip(shards, chunks):
            s[key] = ch.contiguous()
    path.mkdir(parents=True, exist_ok=True)
    for i, s in enumerate(shards):
        torch.save(s, path / f"consolidated.{i:02d}.pth")
    (path / "params.json").write_text(json.dumps({
        "dim": config.dim, "n_layers": config.n_layers, "n_heads": config.n_heads,
        "n_kv_heads": config.n_kv_heads, "norm_eps": config.norm_eps,
        "multiple_of": config.multiple_of, "vocab_size": -1}))
    return path


@pytest.fixture(scope="module")
def source():
    """The JAX package's random tiny tree (numpy) and the same in the port."""
    tree = jax.tree.map(np.asarray, jax_init_params(JCFG, jax.random.PRNGKey(11),
                                                    dtype=jnp.float32))
    return tree, llama_from_numpy(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}{k}.").items()}
    if isinstance(tree, list):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.uint32)


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("file_dtype", ["f32", "bf16"])
def test_meta_convert_equals_jax_bit_for_bit(source, tmp_path, n_shards, file_dtype):
    _, tparams = source
    fdt = torch.float32 if file_dtype == "f32" else torch.bfloat16
    d = write_meta_dir(tmp_path / "meta", meta_state(tparams, fdt), n_shards, CFG)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = _flat(convert_meta_checkpoint(str(d), CFG, dtype=tdt))
        want = _flat(jax.tree.map(np.asarray, jax_convert_meta(str(d), JCFG, dtype=jdt)))
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == tdt and got[key].is_contiguous(), key
            g = to_numpy(got[key])
            assert g.shape == want[key].shape and g.dtype == want[key].dtype, key
            assert np.array_equal(_bits(g), _bits(want[key])), key


def test_meta_convert_round_trips_the_source(source, tmp_path):
    """The merged 2-shard f32 checkpoint is the source tree, exactly."""
    _, tparams = source
    d = write_meta_dir(tmp_path / "meta", meta_state(tparams), 2, CFG)
    got = _flat(convert_meta_checkpoint(str(d), CFG, dtype=torch.float32))
    want = _flat(tparams)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_inverse_permute_is_inverse():
    w = torch.randn(32, 16, generator=torch.Generator().manual_seed(0))

    def hf_permute(w, n_heads):  # Meta -> HF
        out_dim, in_dim = w.shape
        return w.reshape(n_heads, out_dim // n_heads // 2, 2, in_dim).transpose(1, 2).reshape(
            out_dim, in_dim)

    assert torch.equal(_inverse_hf_permute(hf_permute(w, 4), 4), w)


def test_safetensors_reader_equals_the_package(tmp_path):
    """The port's reader against safetensors.numpy.load_file: every dtype a
    LLaMA export uses, a scalar and an empty tensor, and a header with
    metadata."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(0)
    arrays = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "bf16": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i64": rng.integers(-9, 9, (2, 2, 2)).astype(np.int64),
        "i8": rng.integers(-127, 127, (5, 3)).astype(np.int8),
        "scalar": np.asarray(1.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = tmp_path / "model.safetensors"
    save_file(arrays, str(path), metadata={"format": "pt"})
    want, got = load_file(str(path)), load_safetensors(str(path))
    assert got.keys() == want.keys()
    for k in want:
        g = to_numpy(got[k])
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        assert g.tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def hf_model(tmp_path_factory):
    """A local random LlamaForCausalLM (GQA, untied head, the byte
    tokenizer's vocabulary), exported both as pytorch_model.bin and as
    model.safetensors."""
    transformers = pytest.importorskip("transformers")
    from safetensors.torch import save_file

    hf_cfg = transformers.LlamaConfig(
        vocab_size=258, hidden_size=64, intermediate_size=176, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    dirs = {}
    for fmt in ("bin", "safetensors"):
        d = tmp_path_factory.mktemp(f"hf_{fmt}")
        state = {k: v.contiguous() for k, v in model.state_dict().items()}
        if fmt == "bin":
            torch.save(state, d / "pytorch_model.bin")
        else:
            save_file(state, str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
        dirs[fmt] = str(d)
    cfg = LlamaConfig(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=258,
                      norm_eps=1e-5, rope_theta=10000.0, max_batch_size=2, max_seq_len=64)
    return dirs, model, cfg


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_convert_matches_transformers(hf_model, fmt):
    """Logits of the converted tree within 1e-4 of transformers', a 12-token
    prefill at B 2 and 4 cached decode steps after a 5-token prefill; the
    tree equals the JAX converter's bit for bit."""
    dirs, model, cfg = hf_model
    params = convert_hf_checkpoint(dirs[fmt], cfg, dtype=torch.float32)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, 258, (2, 12)))
    with torch.no_grad():
        ours, _ = forward(params, tokens, 0, init_cache(cfg, 2, torch.float32), cfg)
        theirs = model(tokens).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-4)
    cache = init_cache(cfg, 2, torch.float32)
    with torch.no_grad():
        _, cache = forward(params, tokens[:, :5], 0, cache, cfg)
        for i in range(5, 9):
            last, cache = forward(params, tokens[:, i : i + 1], i, cache, cfg)
        theirs = model(tokens[:, :9]).logits[:, -1:]
    np.testing.assert_allclose(last.numpy(), theirs.numpy(), rtol=1e-4, atol=1e-4)
    from prego_tpu.models.llama import LlamaConfig as JaxConfig

    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    want = _flat(jax.tree.map(np.asarray, jax_convert_hf(dirs["bin"], jcfg, dtype=jnp.float32)))
    got = _flat(params)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)


def test_llm_builds_from_a_meta_dir_and_completes(source, tmp_path):
    """TorchLlamaLLM(ckpt_dir=..., tokenizer_path="byte") serves the fused
    converted tree: the same completions as the same weights handed over
    through params=, and under quantize="int8" the same int8 tensors as
    quantizing that tree."""
    tree, tparams = source
    d = write_meta_dir(tmp_path / "meta", meta_state(tparams), 2, CFG)
    kw = dict(max_seq_len=128, max_batch_size=2, device="cpu")
    llm = TorchLlamaLLM(ckpt_dir=str(d), tokenizer_path="byte", **kw)
    assert llm.llama.config.vocab_size == 258 and llm.llama.config.max_seq_len == 128
    assert "wqkv" in llm.llama.params["layers"][0]["attention"]
    bridged = TorchLlamaLLM(params=llama_from_numpy(tree), config=llm.llama.config, **kw)
    prompts = ["abc", "hello world"]
    out = llm.text_completion(prompts, max_gen_len=6, temperature=0.0)
    assert out == bridged.text_completion(prompts, max_gen_len=6, temperature=0.0)
    assert all(isinstance(o["generation"], str) for o in out)
    q = TorchLlamaLLM(ckpt_dir=str(d), tokenizer_path="byte", quantize="int8", **kw)
    qb = TorchLlamaLLM(params=llama_from_numpy(tree), config=llm.llama.config, quantize="int8",
                       **kw)
    a, b = _flat(q.llama.params), _flat(qb.llama.params)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert q.llama.params["output"]["q"].dtype == torch.int8


def test_llm_builds_from_an_hf_dir(hf_model):
    dirs, _, cfg = hf_model
    llm = TorchLlamaLLM(ckpt_dir=dirs["safetensors"], tokenizer_path="byte", max_seq_len=64,
                        max_batch_size=2, device="cpu")
    assert llm.llama.config.n_kv_heads == 2 and llm.llama.config.vocab_size == 258
    out = llm.text_completion(["ab"], max_gen_len=4, temperature=0.0)
    assert len(out) == 1 and isinstance(out[0]["generation"], str)


def test_llm_checkpoint_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        TorchLlamaLLM(ckpt_dir=str(tmp_path / "missing"), tokenizer_path="byte", device="cpu")
    with pytest.raises(ValueError, match="tokenizer_path"):
        TorchLlamaLLM(ckpt_dir=str(tmp_path), device="cpu")
    (tmp_path / "params.json").write_text(json.dumps({"dim": 64, "n_layers": 1, "n_heads": 4}))
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        TorchLlamaLLM(ckpt_dir=str(tmp_path), tokenizer_path="byte", device="cpu")


def _cli_kwargs(*flags):
    argv = flags if "--llm" in flags else ("--llm", "torch-llama", *flags)
    return anticipate.llm_kwargs(anticipate.parse_args(list(argv)))


@pytest.mark.parametrize("flags, message", [
    # --orbax_dir and --model_name are ported: the backends that need a
    # model name refuse to start without one, as the JAX CLI's hf does
    (["--llm", "hf", "--orbax_dir", "x"], "--llm hf requires --model_name"),
    (["--llm", "ollama", "--fabricated", "tiny"], "--llm ollama requires --model_name"),
    (["--ckpt_dir", "x"],
     "--llm torch-llama requires --ckpt_dir and --tokenizer_path (or --fabricated for a "
     "timing run)"),
])
def test_cli_refusals(flags, message):
    with pytest.raises(SystemExit) as exc:
        _cli_kwargs(*flags)
    assert str(exc.value) == message
    if flags[:2] == ["--llm", "hf"]:  # the JAX CLI's own message
        from prego_tpu.cli.anticipate import main as jax_main

        with pytest.raises(SystemExit) as jax_exc:
            jax_main(flags)
        assert str(jax_exc.value) == message


def test_cli_passes_the_checkpoint_flags():
    kw = _cli_kwargs("--ckpt_dir", "d", "--tokenizer_path", "byte", "--quantize",
                     "--orbax_dir", "cache")
    assert (kw["ckpt_dir"], kw["orbax_dir"], kw["quantize"]) == ("d", "cache", "int8")
    assert _cli_kwargs("--llm", "hf", "--model_name", "org/m", "--device", "cpu") == {
        "model_name": "org/m", "device": "cpu"}
    assert _cli_kwargs("--llm", "ollama", "--model_name", "m") == {
        "model_name": "m", "host": "http://127.0.0.1:11434"}
    assert _cli_kwargs("--llm", "fake", "--model_name", "m") == {}


def test_cli_passes_the_checkpoint_flags():
    kw = _cli_kwargs("--ckpt_dir", "some/dir", "--tokenizer_path", "byte", "--quantize")
    assert (kw["ckpt_dir"], kw["tokenizer_path"], kw["quantize"]) == ("some/dir", "byte", "int8")
