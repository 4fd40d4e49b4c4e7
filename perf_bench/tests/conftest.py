"""Tiny cells for the benchmark's CPU tests: BENCHMARK.json's cells with
their configurations and traffic cut to a size the CPU runs in seconds,
written under a temporary root beside copies of the real limits and
metric readers. Nothing here imports jax or the JAX package."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LLM = {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
            "multiple_of": 16, "ffn_dim_multiplier": None, "ffn_hidden": 176,
            "vocab_size": 300, "rope_theta": 10000.0, "norm_eps": 1e-5, "dtype": "float32"}
TINY_RECIPE = {"rgb_type": "rgb_kinetics_bninception", "num_classes": 5, "window_size": 16,
               "embedding_dim": 32, "hidden_dim": 16, "batch_size": 4}
TINY_TRAFFIC = {
    "offline-collection": {"context_tokens": [100, 180], "steps": [3, 6], "videos": 6,
                           "max_seq_len": 320, "max_batch_size": 8, "check_tokens": 40,
                           "warmup_calls": 1, "trace_units": 2},
    "asm101-o-features": {"videos": 4, "frames": [100, 160], "segment_frames": [20, 60],
                          "trace_units": 10},
    "camera-streams": {"streams": 8, "block_frames": 20, "video_blocks": [1, 3],
                       "segment_frames": [20, 60], "blocks": 6, "context_tokens": [100, 180],
                       "max_seq_len": 320, "max_batch_size": 8, "check_tokens": 40,
                       "warmup_blocks": 1},
}
TINY_RECOGNIZER = {"rgb_type": "rgb_kinetics_bninception", "rgb_dim": 1024, "num_classes": 5,
                   "embedding_dim": 32, "hidden_dim": 16}


# the training cell, built and proved but left out of BENCHMARK.json for
# its spread (PERF.md): its entries, for the tests of its loop
TRAIN = ["train-miniroad-asm101"]
PENDING = {
    "configs": [{"name": "miniroad-asm101", "source": "https://github.com/aleflabo/PREGO",
                 "file": "perf_bench/configs/miniroad-asm101.json", "reduced": [],
                 "why": "MiniROAD at the Assembly101-O recipe"}],
    "workloads": [{"name": TRAIN[0], "config": "miniroad-asm101",
                   "traffic": "asm101-o-features", "chips": 1, "why": "training"}],
    "end_to_end": [{"name": "train_windows_per_s", "unit": "windows/s", "better": "higher",
                    "bound": 0.25, "source": "host_clock", "workloads": TRAIN}],
    "per_layer": [{"name": name, "unit": unit, "better": better, "source": "device_trace",
                   "layer": layer, "moves": "train_windows_per_s", "workloads": TRAIN}
                  for name, unit, better, layer in (
                      ("device_idle.train", "%", "lower", "device"),
                      ("mfu.train", "%", "higher", "whole step"),
                      ("K1_roofline.train", "%", "higher", "kernels"),
                      ("K6_roofline.train", "%", "higher", "kernels"),
                      ("h2d_device_ms.train", "ms", "lower", "native data engine"))],
}


def write_tiny_root(root: Path) -> Path:
    """A checkout-like root whose cells are BENCHMARK.json's and the
    training cell's, cut small."""
    (root / "perf_bench").mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in PENDING.items():
        names = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in names]
    for sub in ("configs", "traffic"):
        (root / "perf_bench" / sub).mkdir(exist_ok=True)
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        if "llm" in cfg:
            cfg["llm"] = dict(TINY_LLM)
        if "recipe" in cfg:
            cfg["recipe"].update(TINY_RECIPE)
        if "recognizer" in cfg:
            cfg["recognizer"].update(TINY_RECOGNIZER)
        (root / entry["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        t.update(TINY_TRAFFIC.get(w["traffic"], {}))
        (root / "perf_bench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    shutil.copytree(BENCH_DIR / "limits", root / "perf_bench" / "limits", dirs_exist_ok=True)
    shutil.copytree(BENCH_DIR / "metrics", root / "perf_bench" / "metrics", dirs_exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return write_tiny_root(tmp_path_factory.mktemp("tiny_root"))


@pytest.fixture(scope="module")
def tiny_bench(tiny_root):
    from perf_bench.spec import Bench

    return Bench(tiny_root)
