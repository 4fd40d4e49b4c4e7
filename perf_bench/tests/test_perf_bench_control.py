"""The controls at a size the CPU holds: each comes out as not correct
under the cell's limits, where the program, computing in float32 here,
reads nothing. At the cells' own sizes on the card this is
``test_perf_bench_card.py``'s; PERF.md gives those readings."""

from __future__ import annotations

import json

import pytest
import torch

import conftest
from perf_bench import spec
from perf_bench.loops import Check
from perf_bench.reference import f32_exact
from perf_bench.reference import miniroad as ref_mr

# wider and with the whole vocabulary, so that int8 moves tokens; the
# tokens of four seeds are pooled, as a cell's run at full width compares
# more than a small model's handful
SMALL_LLM = {"dim": 256, "n_layers": 4, "n_heads": 8, "n_kv_heads": 2, "head_dim": 32,
             "ffn_hidden": 688, "vocab_size": 32000}


@pytest.fixture(scope="module")
def small_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("small_root")
    conftest.write_tiny_root(root)
    for entry in json.loads((root / "BENCHMARK.json").read_text())["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        if "llm" in cfg:
            cfg["llm"].update(SMALL_LLM)
            path.write_text(json.dumps(cfg))
    for name in ("offline-collection", "camera-streams"):
        path = root / "perf_bench" / "traffic" / f"{name}.json"
        if path.exists():
            t = json.loads(path.read_text())
            t["check_tokens"] = 320
            path.write_text(json.dumps(t))
    return spec.Bench(root)


@pytest.mark.parametrize("workload", ["anticipate-mistral7b", "online-mistral7b"])
def test_int8_control_of_a_served_model_is_not_correct(small_bench, workload):
    from perf_bench.tools.limits_anticipate import program_int8x8_gaps

    cell = small_bench.cell(workload)
    program, control = [], []
    for seed in (1, 2, 3, 4):
        loop = spec.loop(cell.traffic["loop"]).Loop(cell, seed, torch.device("cpu"))
        loop.setup()
        loop.window(5.0 if workload.startswith("anticipate") else 3.0)
        loop.release()
        loop.check()
        program += [g for r in loop.gaps for g in r]
        control += [g for r in program_int8x8_gaps(loop, *loop.checked) for g in r]
    limit = cell.limits["mean_gap"]["limit"]
    assert Check("mean_gap", sum(program) / len(program), limit).ok
    assert not Check("mean_gap", sum(control) / len(control), limit).ok


def test_bf16_control_of_training_is_not_correct(tiny_bench):
    cell = tiny_bench.cell("train-miniroad-asm101")
    loop = spec.loop("train").Loop(cell, 3, torch.device("cpu"))
    loop.setup()
    loop.release()
    try:
        f32_exact()
        r = loop.reference()
        low = loop.reference(dtype=torch.bfloat16)
        values, _ = ref_mr.compare(low, r, loop.p0)
        program, _ = ref_mr.compare(loop.program_side(), r, loop.p0)
    finally:
        loop.close()
    checks = [Check(k, v, cell.limits[k]["limit"]) for k, v in values.items()]
    assert not all(c.ok for c in checks)
    assert all(Check(k, v, cell.limits[k]["limit"]).ok for k, v in program.items())
