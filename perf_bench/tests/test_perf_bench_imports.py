"""Nothing the harness or the references import is jax or the JAX package
(top-level names compared whole), and the references import nothing of
the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "prego_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_source_of_the_harness_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        assert "prego_tpu_torch" not in _imports(path), path


def test_a_whole_tiny_run_loads_no_forbidden_module(tiny_root):
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from perf_bench import run
from perf_bench.spec import Bench
bench = Bench(Path({str(tiny_root)!r}))
for w in bench.spec["workloads"]:
    run.run_cell(bench, w["name"], 3, 0.5, False, torch.device("cpu"))
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_references_alone_load_nothing_of_the_port():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import perf_bench.reference.llama, perf_bench.reference.miniroad
import perf_bench.reference.prompts, perf_bench.reference.quant
print(sorted(m for m in sys.modules if m.split(".")[0] in ("prego_tpu_torch", "prego_tpu", "jax")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "anticipate-mistral7b", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    import torch

    if torch.cuda.is_available():
        return  # on the card this is a run, which the card tests cover
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_run_fails_where_only_the_benchmark_is(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perf_bench/run.py", "--workload",
                          "anticipate-mistral7b", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
