"""The hf and ollama backends, port against prego_tpu.

hf: the tiny in-memory transformers Llama of tests/test_llm_backends.py
(nothing downloaded) as an injected pipeline gives JAX's generations and
anticipation results; saved to a local directory, the port's CLI
``--llm hf --model_name <dir> --device cpu`` anticipates the same sets as
the JAX CLI, and a fresh interpreter running it loads neither jax nor the
JAX package.

ollama: against a stub Ollama server on localhost, the request bodies are
equal to JAX's and the driver's results through each backend are equal.
The JAX CLI builds ``OllamaLLM()`` without its model name and fails (a
fault of the reference); the port's CLI passes ``--model_name``."""

import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import pytest

from prego_tpu.anticipation import run_anticipation as jax_run_anticipation
from prego_tpu.anticipation.llm import HFPipelineLLM as JaxHF
from prego_tpu.anticipation.llm import OllamaLLM as JaxOllama
from prego_tpu.cli import anticipate as jax_anticipate
from prego_tpu_torch.anticipation import HFPipelineLLM, OllamaLLM, run_anticipation
from prego_tpu_torch.cli import anticipate

REPO = Path(__file__).resolve().parents[1]
GOLDEN = str(REPO / "tests" / "golden" / "synth_seqs.json")
SEQS = {"v0": {"pred": [1, 2, 3, 2], "gt": [1, 2, 3, 3]}, "v1": {"pred": [4, 1], "gt": [4, 1]}}


# ---------------- hf ----------------

@pytest.fixture(scope="module")
def tiny_hf(tmp_path_factory):
    """(pipeline, local directory) of a random tiny Llama with a word-level
    tokenizer of the digits (tests/test_llm_backends.py:19-45)."""
    torch = pytest.importorskip("torch")
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {str(i): i for i in range(50)}
    vocab.update({"[UNK]": 50, "[PAD]": 51, ",": 52, "-1": 53})
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                                pad_token="[PAD]")
    cfg = transformers.LlamaConfig(
        vocab_size=len(vocab), hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=512)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("tiny_hf") / "tiny-llama"
    model.save_pretrained(d)
    fast.save_pretrained(d)
    pipe = transformers.pipeline("text-generation", model=model, tokenizer=fast, device="cpu")
    return pipe, str(d)


def test_hf_generations_equal_jax(tiny_hf):
    pipe, _ = tiny_hf
    prompts = ["1 , 2 , 3", "7 , 7", "4"]
    got = HFPipelineLLM("unused", pipe=pipe).text_completion(prompts, max_gen_len=4,
                                                             temperature=0.0)
    want = JaxHF("unused", pipe=pipe).text_completion(prompts, max_gen_len=4, temperature=0.0)
    assert got == want and len(got) == 3
    assert all(not g["generation"].startswith(p) for g, p in zip(got, prompts))


def test_hf_drives_anticipation_as_jax(tiny_hf):
    pipe, _ = tiny_hf
    kw = dict(dataset="custom", num_samples=2, temperature=0.0, max_gen_len=3,
              type_prompt="num", cleaning_mode="hf")
    got = run_anticipation(SEQS, HFPipelineLLM("unused", pipe=pipe), **kw)
    want = jax_run_anticipation(SEQS, JaxHF("unused", pipe=pipe), **kw)
    assert got.preds == want.preds and got.gts == want.gts and got.metrics == want.metrics


def test_hf_backend_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        HFPipelineLLM("any-model")


def _cli(extra, tmp_path, name):
    return ["--seqs", GOLDEN, "--dataset", "synthcustom", "--temperature", "0.0",
            "--max_gen_len", "3", "--cleaning_mode", "hf",
            "--results_root", str(tmp_path / name), *extra]


def test_hf_cli_equals_jax_cli(tiny_hf, tmp_path):
    _, model_dir = tiny_hf
    want = jax_anticipate.main(_cli(["--llm", "hf", "--model_name", model_dir], tmp_path, "jax"))
    got = anticipate.main(_cli(["--llm", "hf", "--model_name", model_dir, "--device", "cpu"],
                               tmp_path, "port"))
    assert got.preds == want.preds and got.metrics == want.metrics
    # results named the JAX CLI's way: the model id is the dir's last part
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 1
    assert "tiny-llama" in names[0]


def test_hf_subprocess_never_loads_jax(tiny_hf, tmp_path):
    _, model_dir = tiny_hf
    code = (
        "import sys, json\n"
        "from prego_tpu_torch.cli.anticipate import main\n"
        f"r = main({_cli(['--llm', 'hf', '--model_name', model_dir, '--device', 'cpu'], tmp_path, 'r')!r})\n"
        "jax_pkg = sorted(m for m in sys.modules if m == 'prego_tpu' or m.startswith('prego_tpu.'))\n"
        "print(json.dumps({'jax_loaded': 'jax' in sys.modules, 'jax_package': jax_pkg,\n"
        "                  'orbax_loaded': any(m.startswith('orbax') for m in sys.modules),\n"
        "                  'samples': r.metrics['samples']}))\n"
    )
    report = run_fresh(code, tmp_path)
    assert report["jax_loaded"] is False and report["jax_package"] == []
    assert report["orbax_loaded"] is False
    assert report["samples"] == sum(len(v["pred"]) for v in json.load(open(GOLDEN)).values())


def run_fresh(code, cwd):
    """Run ``code`` in a fresh interpreter; its last stdout line as JSON."""
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---------------- ollama ----------------

class _StubOllama(BaseHTTPRequestHandler):
    """Answers /api/chat with a number that depends on the prompt."""

    bodies = []

    def do_POST(self):
        assert self.path == "/api/chat"
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).bodies.append(body)
        prompt = body["messages"][-1]["content"]
        data = json.dumps({"message": {"role": "assistant",
                                       "content": str(len(prompt) % 5 + 1)}}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def stub():
    _StubOllama.bodies = []
    server = HTTPServer(("127.0.0.1", 0), _StubOllama)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("max_gen_len", [8, None])
def test_ollama_request_bodies_equal_jax(stub, max_gen_len):
    prompts = ["what comes after 1, 2?", "and after 3?"]
    got = OllamaLLM("llama3.2:1b", host=stub).text_completion(
        prompts, max_gen_len=max_gen_len, temperature=0.3, top_p=0.85)
    port_bodies = list(_StubOllama.bodies)
    _StubOllama.bodies.clear()
    want = JaxOllama("llama3.2:1b", host=stub).text_completion(
        prompts, max_gen_len=max_gen_len, temperature=0.3, top_p=0.85)
    assert got == want
    assert port_bodies == _StubOllama.bodies and len(port_bodies) == 2
    assert ("num_predict" in port_bodies[0]["options"]) == (max_gen_len is not None)


def test_ollama_drives_anticipation_as_jax(stub):
    kw = dict(dataset="custom", num_samples=2, temperature=0.0, max_gen_len=3,
              type_prompt="num")
    got = run_anticipation(SEQS, OllamaLLM("m", host=stub), **kw)
    want = jax_run_anticipation(SEQS, JaxOllama("m", host=stub), **kw)
    assert got.preds == want.preds and got.metrics == want.metrics


def test_ollama_cli(stub, tmp_path):
    """The port's CLI passes --model_name to ollama and gets the driver's
    result through the JAX backend; the JAX CLI cannot build its ollama
    backend (no model name: TypeError, before any request)."""
    got = anticipate.main(_cli(["--llm", "ollama", "--model_name", "m", "--ollama_host", stub],
                               tmp_path, "port"))
    assert {b["model"] for b in _StubOllama.bodies} == {"m"}
    seqs = json.load(open(GOLDEN))
    want = jax_run_anticipation(seqs, JaxOllama("m", host=stub), dataset="synthcustom",
                                temperature=0.0, max_gen_len=3, cleaning_mode="hf")
    assert got.preds == want.preds and got.metrics == want.metrics
    with pytest.raises(TypeError, match="model_name"):
        jax_anticipate.main(_cli(["--llm", "ollama", "--model_name", "m"], tmp_path, "jax"))
