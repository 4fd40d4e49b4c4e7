"""The whole slice at a tiny size, port against prego_tpu: recognition
eval JSON -> aggregation -> anticipation with the LLaMA backend (greedy,
the same tiny weights handed over) -> mistake verdicts and metrics. Also
drives the port's train and pipeline CLIs in a subprocess and checks that
they never load jax or any module of the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
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


def test_port_pipeline_cli_never_loads_jax(setup, tmp_path):
    """The port's train CLI (one epoch) and then its pipeline CLI on the
    trained checkpoint (eval -> aggregate -> torch-llama with fabricated
    tiny weights -> metrics) in a fresh interpreter: afterwards neither jax
    nor any module of the JAX package (prego_tpu, prego_tpu.*) is loaded."""
    _, cfg_path, _ = setup
    workdir = tmp_path / "wd"
    code = (
        "import glob, sys, json\n"
        "from prego_tpu_torch.cli.train import main as train\n"
        "from prego_tpu_torch.cli.pipeline import main\n"
        f"train(['--config', {str(cfg_path)!r}, '--output_path', {str(tmp_path / 'out')!r},\n"
        "       '--device', 'cpu'])\n"
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


def test_training_is_refused_with_the_roadmap_item(setup):
    """Recognition training is ported; the ANTICIPATION task's is not (M9)."""
    _, cfg_path, _ = setup
    with pytest.raises(NotImplementedError, match="M9"):
        train_main(["--config", str(cfg_path), "--device", "cpu", "--task", "ANTICIPATION"])
