"""The whole slice at a tiny size, port against prego_tpu: recognition
eval JSON -> aggregation -> anticipation with the LLaMA backend (greedy,
the same tiny weights handed over; bf16/f32, int8 and int8 x int8 weights)
-> mistake verdicts and metrics, with the LLM in batch and in cb mode.
Also drives the port's train, pipeline, quantized and cb anticipate CLIs
and the online detector in a subprocess and checks that they never load
jax or any module of the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from prego_tpu.aggregate import aggregate
from prego_tpu.anticipation import run_anticipation as jax_run_anticipation
from prego_tpu.anticipation.llm import JaxLlamaLLM
from prego_tpu.checkpoint import save_checkpoint
from prego_tpu.cli.schema_check import check_aggregated, check_perframe
from prego_tpu.cli.train import main as jax_train_main
from prego_tpu.core import RecognitionConfig as JaxConfig
from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
from prego_tpu_torch.anticipation import run_anticipation
from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.cli.train import main as train_main
from prego_tpu_torch.models.llama import LlamaConfig
from tests.synth import make_synth_dataset

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pipe")
    data_root, vl_path, _, _ = make_synth_dataset(
        str(root), num_train=1, num_test=3, num_classes=5, rgb_dim=1024,
        min_len=300, max_len=520, seed=6, rgb_type="rgb_kinetics_bninception",
    )
    cfg = {
        "model": "MiniROAD", "data_name": "SYNTH", "task": "OAD",
        "loss": "NONUNIFORM", "metric": "AP", "optimizer": "AdamW",
        "feature_pretrained": "synth", "root_path": data_root,
        "rgb_type": "rgb_kinetics_bninception", "flow_type": "flow_anet_resnet50",
        "annotation_type": "target_perframe", "video_list_path": vl_path,
        "output_path": str(root / "out"), "window_size": 16, "batch_size": 8,
        "num_epoch": 1, "lr": 0.003, "weight_decay": 0.05, "dropout": 0.1,
        "num_classes": 5, "embedding_dim": 48, "hidden_dim": 32,
        "num_layers": 1, "stride": 4,
    }
    cfg_path = root / "synth.yaml"
    cfg_path.write_text(yaml.dump(cfg))
    model = JaxMiniROAD(JaxConfig.from_dict(cfg))
    ckpt = root / "init.ckpt"
    save_checkpoint(str(ckpt), model.init(jax.random.PRNGKey(3)))
    return root, cfg_path, ckpt


def _eval(main, cfg_path, ckpt, out_dir, extra=()):
    main(["--config", str(cfg_path), "--eval", str(ckpt), "--eval_output_dir", str(out_dir),
          "--eval_output_name", "perframe.json", *extra])
    return json.loads((out_dir / "perframe.json").read_text())


def test_slice_matches_jax(setup, tmp_path):
    root, cfg_path, ckpt = setup
    # 1. recognition eval: equal per-frame argmax for every video
    jraw = _eval(jax_train_main, cfg_path, ckpt, tmp_path / "jax")
    traw = _eval(train_main, cfg_path, ckpt, tmp_path / "torch", ["--device", "cpu"])
    check_perframe(traw)
    assert traw == jraw
    # 2. aggregation (numpy, shared): the same step sequences
    agg = aggregate(traw, str(tmp_path / "agg.json"))
    check_aggregated(json.loads((tmp_path / "agg.json").read_text()))
    assert agg == aggregate(jraw)
    # 3. anticipation: torch-llama against jax-llama on the same tiny weights
    jllm = JaxLlamaLLM(ckpt_dir="", tokenizer_path="", fabricated="tiny", max_seq_len=256)
    jcfg = jllm.llama.config
    tcfg = LlamaConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    tllm = TorchLlamaLLM(
        params=llama_from_numpy(jax.tree.map(np.asarray, jllm.llama.params)),
        config=tcfg, device="cpu",
    )
    kw = dict(dataset="synthcustom", max_gen_len=6, temperature=0.0, num_samples=2)
    want = jax_run_anticipation(agg, jllm, **kw)
    got = run_anticipation(agg, tllm, **kw)
    # 4. the same anticipated sets, verdicts and one-class metrics
    assert got.preds == want.preds and got.gts == want.gts
    assert got.metrics == want.metrics
    assert tllm.llama.decode_steps > 0


@pytest.fixture(scope="module")
def aggregated(setup, tmp_path_factory):
    """The port's recognition eval of the init checkpoint, aggregated."""
    _, cfg_path, ckpt = setup
    out = tmp_path_factory.mktemp("torch_pipe_agg")
    raw = _eval(train_main, cfg_path, ckpt, out, ["--device", "cpu"])
    return aggregate(raw, str(out / "agg.json")), out / "agg.json"


@pytest.mark.parametrize("quantize", ["int8", "int8x8"])
def test_quantized_slice_matches_jax(aggregated, quantize):
    """jax-llama with quantized tiny weights against torch-llama on the
    same int8 tree through the bridge: the same anticipated sets,
    verdicts and metrics, greedy."""
    agg, _ = aggregated
    jllm = JaxLlamaLLM(ckpt_dir="", tokenizer_path="", fabricated="tiny", max_seq_len=256,
                       quantize=quantize)
    jcfg = jllm.llama.config
    tllm = TorchLlamaLLM(
        params=llama_from_numpy(jax.tree.map(np.asarray, jllm.llama.params)),
        config=LlamaConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}),
        device="cpu", quantize=quantize,
    )
    wqkv = tllm.llama.params["layers"][0]["attention"]["wqkv"]
    assert wqkv["q"].dtype == torch.int8 and ("act" in wqkv) == (quantize == "int8x8")
    kw = dict(dataset="synthcustom", max_gen_len=6, temperature=0.0, num_samples=2)
    want = jax_run_anticipation(agg, jllm, **kw)
    got = run_anticipation(agg, tllm, **kw)
    assert got.preds == want.preds and got.gts == want.gts
    assert got.metrics == want.metrics
    assert tllm.llama.decode_steps > 0


def test_port_quantized_anticipate_cli_never_loads_jax(aggregated, tmp_path):
    """--quantize int8 --kv_quant through the port's anticipate CLI in a
    fresh interpreter (int8 weights drawn directly, int8 KV cache, CPU):
    metrics come out, the prefix-cache line logs the generation counters,
    and neither jax nor the JAX package is loaded."""
    agg, agg_path = aggregated
    code = (
        "import sys, json\n"
        "from prego_tpu_torch.cli.anticipate import main\n"
        f"r = main(['--llm', 'torch-llama', '--fabricated', 'tiny', '--quantize', 'int8',\n"
        f"          '--kv_quant', '--dataset', 'synthcustom', '--seqs', {str(agg_path)!r},\n"
        f"          '--results_root', {str(tmp_path / 'results')!r}, '--max_gen_len', '4',\n"
        "          '--max_seq_len', '256', '--device', 'cpu'])\n"
        "jax_pkg = sorted(m for m in sys.modules if m == 'prego_tpu' or m.startswith('prego_tpu.'))\n"
        "print(json.dumps({'jax_loaded': 'jax' in sys.modules, 'jax_package': jax_pkg,\n"
        "                  'samples': r.metrics['samples']}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax_loaded"] is False
    assert report["jax_package"] == []
    assert report["samples"] == sum(len(v["pred"]) for v in agg.values())
    assert (tmp_path / "results").exists()
    # the closing prefix-cache line carries the batch path's counters
    (line,) = [ln for ln in proc.stderr.splitlines() if "prefix cache:" in ln]
    for key in ("tokens_reused=", "suffix_tokens_prefilled=", "per_row_calls=",
                "decode_steps="):
        assert key in line, line
    assert "utilization=" not in line


def test_port_spec_and_checkpoint_anticipate_cli_never_load_jax(aggregated, tmp_path):
    """In a fresh interpreter: the port's anticipate CLI with speculative
    decoding (--spec_k 2 --spec_draft self-1, tiny weights), then with a
    Meta checkpoint directory (--ckpt_dir, --tokenizer_path byte) written
    from seeded random weights, twice more with --quantize int8 --orbax_dir
    (the first run writes the int8 cache, the second restores it and
    anticipates the same sets), and with --llm ollama against a stub server
    on localhost: results come out, the speculation line is logged, and
    neither jax, orbax nor the JAX package is loaded."""
    import threading
    from http.server import HTTPServer

    from prego_tpu_torch.models.llama import init_params, tiny_test_config
    from tests.test_torch_convert import meta_state, write_meta_dir
    from tests.test_torch_llm_backends import _StubOllama

    agg, agg_path = aggregated
    cfg = tiny_test_config(vocab_size=258)
    ckpt = write_meta_dir(tmp_path / "llama-tiny",
                          meta_state(init_params(cfg, torch.Generator().manual_seed(4),
                                                 dtype=torch.float32)), 2, cfg)
    common = (f"'--dataset', 'synthcustom', '--seqs', {str(agg_path)!r}, '--max_gen_len', '4',\n"
              "'--max_seq_len', '256', '--device', 'cpu', '--temperature', '0'")
    code = (
        "import sys, json\n"
        "from prego_tpu_torch.cli.anticipate import main\n"
        "r1 = main(['--llm', 'torch-llama', '--fabricated', 'tiny', '--spec_k', '2',\n"
        f"           '--spec_draft', 'self-1', '--results_root', {str(tmp_path / 'r1')!r},\n"
        f"           {common}])\n"
        f"r2 = main(['--llm', 'torch-llama', '--ckpt_dir', {str(ckpt)!r},\n"
        "           '--tokenizer_path', 'byte', '--quantize', 'int8',\n"
        f"           '--results_root', {str(tmp_path / 'r2')!r}, {common}])\n"
        "cached = []\n"
        "for i in range(2):\n"
        f"    cached.append(main(['--llm', 'torch-llama', '--ckpt_dir', {str(ckpt)!r},\n"
        "        '--tokenizer_path', 'byte', '--quantize', 'int8',\n"
        f"        '--orbax_dir', {str(tmp_path / 'cache')!r},\n"
        f"        '--results_root', {str(tmp_path / 'r3')!r} + str(i), {common}]))\n"
        "r5 = main(['--llm', 'ollama', '--model_name', 'm', '--ollama_host', HOST,\n"
        f"           '--results_root', {str(tmp_path / 'r5')!r}, {common}])\n"
        "jax_pkg = sorted(m for m in sys.modules if m == 'prego_tpu' or m.startswith('prego_tpu.'))\n"
        "print(json.dumps({'jax_loaded': 'jax' in sys.modules, 'jax_package': jax_pkg,\n"
        "                  'orbax_loaded': any(m.startswith('orbax') for m in sys.modules),\n"
        "                  'cached_sets_equal': cached[0].preds == cached[1].preds == r2.preds,\n"
        "                  'samples': [r.metrics['samples'] for r in (r1, r2, *cached, r5)]}))\n"
    )
    _StubOllama.bodies = []
    server = HTTPServer(("127.0.0.1", 0), _StubOllama)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    code = f"HOST = 'http://127.0.0.1:{server.server_port}'\n" + code
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=600)
    finally:
        server.shutdown()
        server.server_close()
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax_loaded"] is False
    assert report["jax_package"] == []
    assert report["orbax_loaded"] is False
    n_steps = sum(len(v["pred"]) for v in agg.values())
    assert report["samples"] == [n_steps] * 5
    assert report["cached_sets_equal"] is True
    assert {b["model"] for b in _StubOllama.bodies} == {"m"} and _StubOllama.bodies
    assert "speculation: rounds=" in proc.stderr + proc.stdout
    assert (tmp_path / "r1").exists() and (tmp_path / "r2").exists()
    assert (tmp_path / "cache" / "manifest.json").exists()


def test_cb_slice_matches_jax(aggregated):
    """jax-llama against torch-llama on the same tiny weights, both with
    --serving cb (the continuous-batching slot loop): the same anticipated
    sets, verdicts and metrics, greedy, every call through the slots."""
    agg, _ = aggregated
    jllm = JaxLlamaLLM(ckpt_dir="", tokenizer_path="", fabricated="tiny", max_seq_len=256,
                       serving="cb", cb_slots=4)
    jcfg = jllm.llama.config
    tllm = TorchLlamaLLM(
        params=llama_from_numpy(jax.tree.map(np.asarray, jllm.llama.params)),
        config=LlamaConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}),
        device="cpu", serving="cb", cb_slots=4,
    )
    kw = dict(dataset="synthcustom", max_gen_len=6, temperature=0.0, num_samples=2)
    want = jax_run_anticipation(agg, jllm, **kw)
    got = run_anticipation(agg, tllm, **kw)
    assert got.preds == want.preds and got.gts == want.gts
    assert got.metrics == want.metrics
    assert tllm._cb is not None and tllm.llama.decode_steps == 0


def test_port_cb_cli_and_online_detector_never_load_jax(setup, aggregated, tmp_path):
    """In a fresh interpreter: the port's anticipate CLI with --serving cb
    (tiny weights, CPU), then the online multi-stream detector (the init
    checkpoint's MiniROAD, checks through torch-llama in cb mode) over two
    streams of frames: results come out, the prefix-cache line logs the
    slots' counts and utilization, and neither jax nor the JAX package is
    loaded."""
    _, _, ckpt = setup
    agg, agg_path = aggregated
    code = (
        "import sys, json\n"
        "import numpy as np\n"
        "from prego_tpu_torch.cli.anticipate import main\n"
        f"r = main(['--llm', 'torch-llama', '--fabricated', 'tiny', '--serving', 'cb',\n"
        f"          '--cb_slots', '4', '--dataset', 'synthcustom', '--seqs', {str(agg_path)!r},\n"
        f"          '--results_root', {str(tmp_path / 'results')!r}, '--max_gen_len', '4',\n"
        "          '--max_seq_len', '256', '--device', 'cpu'])\n"
        "from prego_tpu_torch.anticipation import TorchLlamaLLM\n"
        "from prego_tpu_torch.checkpoint import load_params\n"
        "from prego_tpu_torch.checkpoint.bridge import miniroad_from_numpy\n"
        "from prego_tpu_torch.core import RecognitionConfig\n"
        "from prego_tpu_torch.models.miniroad import MiniROAD\n"
        "from prego_tpu_torch.serving import MultiStreamMistakeDetector, OnlineRecognizer\n"
        "cfg = RecognitionConfig.from_dict({'rgb_type': 'rgb_kinetics_bninception',\n"
        "    'flow_type': 'flow_anet_resnet50', 'embedding_dim': 48, 'hidden_dim': 32,\n"
        "    'num_layers': 1, 'num_classes': 5, 'dropout': 0.0})\n"
        "model = MiniROAD(cfg)\n"
        f"params = miniroad_from_numpy(load_params({str(ckpt)!r}))\n"
        "llm = TorchLlamaLLM(fabricated='tiny', serving='cb', max_seq_len=256, device='cpu')\n"
        "det = MultiStreamMistakeDetector(OnlineRecognizer(model, params, batch=2, device='cpu'),\n"
        "    llm, window_size=8, temperature=0.0, max_gen_len=3)\n"
        "frames = np.random.default_rng(0).normal(0, 1, (40, 2, model.rgb_dim)).astype(np.float32)\n"
        "for t0 in range(0, 40, 16):\n"
        "    det.push_frames(frames[t0:t0 + 16])\n"
        "det.finish()\n"
        "jax_pkg = sorted(m for m in sys.modules if m == 'prego_tpu' or m.startswith('prego_tpu.'))\n"
        "print(json.dumps({'jax_loaded': 'jax' in sys.modules, 'jax_package': jax_pkg,\n"
        "                  'samples': r.metrics['samples'], 'frames': det.frame_index,\n"
        "                  'events': sum(len(e) for e in det.events)}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax_loaded"] is False
    assert report["jax_package"] == []
    assert report["samples"] == sum(len(v["pred"]) for v in agg.values())
    assert report["frames"] == [40, 40] and report["events"] >= 2
    assert (tmp_path / "results").exists()
    # under --serving cb the prefix-cache line adds the slots' counts
    (line,) = [ln for ln in proc.stderr.splitlines() if "prefix cache:" in ln]
    assert "; cb: tokens_reused=" in line and "utilization=" in line, line


def test_port_pipeline_cli_never_loads_jax(setup, tmp_path):
    """The port's train CLI (one epoch each: on the native data backend,
    and MiniROADA on the ANTICIPATION task) and then its pipeline CLI on
    the native run's checkpoint (eval -> aggregate -> torch-llama with
    fabricated tiny weights -> metrics) in a fresh interpreter: afterwards
    neither jax nor any module of the JAX package (prego_tpu, prego_tpu.*)
    is loaded."""
    _, cfg_path, _ = setup
    workdir = tmp_path / "wd"
    code = (
        "import glob, sys, json\n"
        "from prego_tpu_torch.cli.train import main as train\n"
        "from prego_tpu_torch.cli.pipeline import main\n"
        f"train(['--config', {str(cfg_path)!r}, '--output_path', {str(tmp_path / 'out')!r},\n"
        "       '--device', 'cpu', '--data_backend', 'native'])\n"
        f"ant = train(['--config', {str(cfg_path)!r}, '--output_path', {str(tmp_path / 'ant')!r},\n"
        "             '--device', 'cpu', '--model', 'MiniROADA', '--task', 'ANTICIPATION',\n"
        "             '--loss', 'ANTICIPATION', '--anticipation_length', '3'])\n"
        "assert 0.0 < ant <= 1.0\n"
        f"ckpt, = glob.glob({str(tmp_path / 'out')!r} + '/*/ckpts/best_*.ckpt')\n"
        f"r = main(['--config', {str(cfg_path)!r}, '--ckpt', ckpt,\n"
        f"          '--workdir', {str(workdir)!r}, '--llm', 'torch-llama',\n"
        "          '--fabricated', 'tiny', '--dataset', 'synthcustom',\n"
        f"          '--data_root', {str(tmp_path)!r}, '--max_gen_len', '4', '--device', 'cpu'])\n"
        "assert r.metrics is not None\n"
        "jax_pkg = sorted(m for m in sys.modules if m == 'prego_tpu' or m.startswith('prego_tpu.'))\n"
        "print(json.dumps({'jax_loaded': 'jax' in sys.modules, 'jax_package': jax_pkg,\n"
        "                  'samples': r.metrics['samples']}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)  # the JAX package would import jax for it
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax_loaded"] is False
    assert report["jax_package"] == []
    agg = json.loads((workdir / "aggregated.json").read_text())
    assert report["samples"] == sum(len(v["pred"]) for v in agg.values())
    assert (workdir / "results").exists()


def test_training_is_refused_with_the_roadmap_item(setup, tmp_path):
    """Recognition training is ported in every setting the JAX CLI runs, and
    refuses only what that CLI refuses (ANTICIPATION on the native data
    backend); the pipeline runs every backend the JAX one does and refuses
    what it refuses (--llm hf without --model_name, after recognition, with
    the JAX CLI's message)."""
    from prego_tpu_torch.cli.pipeline import main as pipeline_main

    _, cfg_path, ckpt = setup
    with pytest.raises(SystemExit, match="numpy data backend"):
        train_main(["--config", str(cfg_path), "--device", "cpu", "--model", "MiniROADA",
                    "--task", "ANTICIPATION", "--loss", "ANTICIPATION",
                    "--anticipation_length", "3", "--data_backend", "native"])
    with pytest.raises(SystemExit, match="^--llm hf requires --model_name$"):
        pipeline_main(["--config", str(cfg_path), "--ckpt", str(ckpt), "--workdir",
                       str(tmp_path / "wd"), "--llm", "hf", "--dataset", "synthcustom",
                       "--device", "cpu"])
    assert (tmp_path / "wd" / "aggregated.json").exists()
