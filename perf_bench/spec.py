"""Finds a cell's configuration, traffic, metric readers and limits by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with what it needs, read from its files."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics its traced run reports
    limits: dict = field(default_factory=dict)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files under ``bench_dir``."""

    def __init__(self, root: Path = ROOT, bench_dir: Optional[Path] = None):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir) if bench_dir is not None else self.root / "perf_bench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        with open(self.root / self._entry("configs", name)["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        path = self.bench_dir / "limits" / f"{workload}.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return json.load(f)

    def metric_reader(self, name: str) -> Callable:
        """``read(ctx)`` of ``metrics/<name>.py``: a number, or None where the
        trace holds nothing to read."""
        path = self.bench_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"perf_bench_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or name in m["workloads"]]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
        return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                    chips=int(w["chips"]), config=self.config(w["config"]),
                    traffic=self.traffic(w["traffic"]), end_to_end=e2e, per_layer=per_layer,
                    limits=self.limits(name))


def loop(kind: str):
    """``loops/<kind>.py``: the closed loop that runs a kind of traffic."""
    return importlib.import_module(f"perf_bench.loops.{kind}")
