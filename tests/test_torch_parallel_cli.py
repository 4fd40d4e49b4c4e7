"""The port's anticipate CLI under ``python -m torch.distributed.run`` with 2
ranks on the CPU (gloo), over a tiny Meta checkpoint written here: the
model is split over the ranks (tp 2 by default in bf16), rank 0 alone
writes the results, and they equal the single-process run's. Neither rank
imports jax or the JAX package (``PYTHONPROFILEIMPORTTIME`` lists every
module each interpreter imports)."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch

from prego_tpu_torch.models.llama import tiny_test_config
from prego_tpu_torch.models.llama.model import init_params

REPO = Path(__file__).resolve().parents[1]
SEQS = REPO / "tests" / "golden" / "synth_seqs.json"


def _imported(stderr: str):
    """Module names from ``-X importtime`` lines."""
    out = set()
    for line in stderr.splitlines():
        if line.startswith("import time:") and line.count("|") == 2:
            out.add(line.rsplit("|", 1)[1].strip())
    return out


def _results(root: Path):
    (run,) = [p for p in root.iterdir() if p.is_dir()]
    out = {}
    for f in sorted(run.iterdir()):
        if f.suffix == ".pkl":
            out[f.name] = pickle.loads(f.read_bytes())
        else:
            metrics = json.loads(f.read_text())
            out[f.name] = {k: v for k, v in metrics.items() if k != "mean_llm_call_s"}
    return out


def test_anticipate_cli_under_two_ranks(tmp_path):
    from tests.test_torch_convert import meta_state, write_meta_dir

    cfg = tiny_test_config(vocab_size=258)
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    ckpt = write_meta_dir(tmp_path / "meta", meta_state(params), 1, cfg)
    args = ["--llm", "torch-llama", "--ckpt_dir", str(ckpt), "--tokenizer_path", "byte",
            "--dataset", "synthcustom", "--seqs", str(SEQS), "--max_gen_len", "4",
            "--max_seq_len", "256", "--temperature", "0", "--num_samples", "2",
            "--device", "cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PREGO_PLATFORM", None)
    single = subprocess.run(
        [sys.executable, "-m", "prego_tpu_torch.cli.anticipate", *args,
         "--results_root", str(tmp_path / "single")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert single.returncode == 0, single.stderr[-3000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "prego_tpu_torch.cli.anticipate", *args, "--results_root", str(tmp_path / "tp")],
        cwd=str(tmp_path), env={**env, "PYTHONPROFILEIMPORTTIME": "1"},
        capture_output=True, text=True, timeout=600)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    imported = _imported(ranks.stderr)
    assert "prego_tpu_torch.parallel.sharding" in imported  # the ranks' imports are listed
    assert not [m for m in imported if m == "jax" or m.startswith("jax.")
                or m == "prego_tpu" or m.startswith("prego_tpu.")]
    log = ranks.stdout + ranks.stderr
    assert log.count("torch-llama over 2 tensor-parallel rank(s)") == 2
    assert "torch-llama over 1 tensor-parallel rank(s)" in single.stdout + single.stderr
    assert log.count("results saved to") == 1  # rank 0 alone writes
    got, want = _results(tmp_path / "tp"), _results(tmp_path / "single")
    assert sorted(got) == ["metrics.json", "plot.pkl", "torch_llama_gts.pkl",
                           "torch_llama_preds.pkl"]
    assert got == want
