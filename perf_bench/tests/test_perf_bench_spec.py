"""A configuration, a traffic mix and a per-layer metric added as new files
(and BENCHMARK.json entries) are found by their names, with no file of the
harness edited."""

from __future__ import annotations

import json

from perf_bench.spec import Bench


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    root = tmp_path / "root"
    import shutil

    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "perf_bench" / "configs" / "new-model.json").write_text(json.dumps(
        {"llm": {"dim": 8}, "reduced": []}))
    (root / "perf_bench" / "traffic" / "new-mix.json").write_text(json.dumps(
        {"loop": "anticipate", "toys": 2}))
    (root / "perf_bench" / "metrics" / "new_metric.newcell.py").write_text(
        "def read(loop):\n    return 42.0 if loop == 'trace' else None\n")
    bench["configs"].append({"name": "new-model", "source": "https://example.org/m",
                             "file": "perf_bench/configs/new-model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "newcell", "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "new_rate", "unit": "x/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["newcell"]})
    bench["per_layer"].append({"name": "new_metric.newcell", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "new_rate"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = Bench(root)
    cell = b.cell("newcell")
    assert cell.config == {"llm": {"dim": 8}, "reduced": []}
    assert cell.traffic["toys"] == 2
    assert sorted(m["name"] for m in cell.end_to_end) == ["new_rate", "setup_s"]
    # without a workloads key a metric goes to every cell reporting what it moves
    assert [m["name"] for m in cell.per_layer] == ["new_metric.newcell"]
    read = b.metric_reader("new_metric.newcell")
    assert read("trace") == 42.0 and read("nothing") is None
    assert cell.limits == {}
    # the cells already there are untouched
    assert "new_rate" not in [m["name"] for m in b.cell("anticipate-mistral7b").end_to_end]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from conftest import ROOT

    b = Bench(ROOT)
    for w in b.spec["workloads"]:
        cell = b.cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert (b.bench_dir / "limits" / f"{w['name']}.json").exists()
        for m in cell.per_layer:
            assert (b.bench_dir / "metrics" / f"{m['name']}.py").exists()
