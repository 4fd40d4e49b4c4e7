"""The controls on the card, at the cells' own sizes (one seed each):
the program's numbers pass their limits, the lower precision reads past
them. Needs an NVIDIA GPU; skips without one (decided
inside each test). On the card:

    python -m pytest -m cuda perf_bench/tests/test_perf_bench_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT

pytestmark = pytest.mark.cuda


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")


def _tool(name, *args):
    out = subprocess.run([sys.executable, str(BENCH_DIR / "tools" / name), *args],
                         capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def _limits(workload):
    return json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text())


def test_anticipation_control_fails_and_the_program_passes():
    _need_card()
    lim = _limits("anticipate-mistral7b")["mean_gap"]["limit"]
    (row,) = _tool("limits_anticipate.py", "--workload", "anticipate-mistral7b",
                   "--seeds", "90001", "--seconds", "12", "--control")
    assert row["program"]["mean"] <= lim < row["program_int8x8"]["mean"]
    assert row["checks"]["missing_answers"] == 0


def test_online_controls_fail_and_the_program_passes():
    _need_card()
    limits = _limits("online-mistral7b")
    (row,) = _tool("limits_anticipate.py", "--workload", "online-mistral7b",
                   "--seeds", "90002", "--seconds", "20", "--control")
    assert all(v <= (limits[k]["limit"] if k in limits else 0.0)
               for k, v in row["checks"].items())
    assert row["recognizer_bf16_id_mismatch"] > limits["id_mismatch"]["limit"]
