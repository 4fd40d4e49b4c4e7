#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perf_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, perf_bench/ and the
port (prego_tpu_torch). The run draws its inputs and weights from
``--seed``, warms up the cell's shapes (set-up, timed as ``setup_s``),
measures for ``--seconds``, then checks what the window produced against
the plain reference. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiler trace of the window's first units. It refuses to run without as
many CUDA devices as the cell asks for, and prints no result where the
process holds jax or the JAX package once the window has closed.

The last line of standard output is one JSON object; the numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks``, the result's last key.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "prego_tpu")

# every cache of a build or compile lives at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# transformers, where anything imports it, must not bring in jax
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not hold,
    compared whole (``prego_tpu_torch`` is not ``prego_tpu``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set-up, window, release and check of one cell. Returns the result."""
    import torch

    from perf_bench import spec, tracing

    cell = bench.cell(name)
    loop = spec.loop(cell.traffic["loop"]).Loop(cell, seed, device)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    loop.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tracer = tracing.Tracer(device) if trace else None
    loop.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"perf_bench: the process holds {', '.join(found)} after the window: "
                         "no result")
    metrics = {}
    result = {}
    if trace:
        loop.trace = tracer.result()
        for m in cell.per_layer:
            value = bench.metric_reader(m["name"])(loop)
            if value is not None and not math.isnan(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = loop.end_to_end()
        measured["setup_s"] = (setup_s, "s")
        for m in cell.end_to_end:
            value, unit = measured[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    loop.release()
    try:
        checks = loop.check()
    finally:
        loop.close()
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace and loop.trace is not None:
        device_info["busy_s"] = loop.trace.busy_s
        device_info["window_s"] = loop.trace.window_s
        result["breakdown"] = loop.trace.breakdown()
    out = {"correct": all(c.ok for c in checks), "attempted": int(loop.attempted),
           "failed": int(loop.failed), "metrics": metrics, "device": device_info}
    out.update(result)
    # the window's units: host clock and work (checks a call or a block, windows an epoch)
    out["units"] = [[round(s, 4), w] for s, w in zip(loop.unit_seconds, loop.unit_work)]
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from perf_bench.spec import Bench

    bench = Bench(ROOT)
    chips = bench.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perf_bench: the cell needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"perf_bench: the process holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print("units " + json.dumps(out["units"]))  # [seconds, work] of each unit of the window
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
