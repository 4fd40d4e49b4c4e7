"""The readings that set the limit of ``anticipate-dsv2lite``'s ``mean_gap``,
on the card at the cell's own size, all seeds in one process.

For each seed: a sound run of the program (set-up, a window of
``--seconds``, the check's sample against the float32 reference), then,
with ``--control``, the lower-precision control on the same prompts and
served tokens: the plain DeepSeek-V2 reference with every product's
operands rounded to int8 (``reference/quant.py``: the router, the
attention projections, each expert and the lm-head), read as the gap of
the token that it puts first. The limit lies between the program's
largest mean and the control's smallest.

Runs only on a CUDA card, as ``run.py`` does: on the CPU the loop serves
in float32, whose gaps say nothing of the bf16 program. Each row names
the card it was read on.

    python3 perf_bench/tools/limits_dsv2.py --seeds 11,12,13 --seconds 12 --control \
        --out build/limits_dsv2.jsonl

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perf_bench.tools.limits_anticipate import summary  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="anticipate-dsv2lite")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perf_bench import spec
    from perf_bench.reference import deepseek_v2 as ref_dsv2
    from perf_bench.reference import f32_exact, quant

    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("limits_dsv2: the readings are of the bf16 program on a CUDA card, "
              "and this machine has none", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(dev)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        loop = spec.loop(cell.traffic["loop"]).Loop(cell, seed, dev)
        loop.setup()
        loop.window(args.seconds)
        loop.release()
        checks = {c.name: c.value for c in loop.check()}
        row = {"seed": seed, "device": card, "checks": checks, "units": len(loop.unit_seconds),
               "window_s": loop.window_s, "end_to_end": loop.end_to_end(),
               "program": summary(loop.gaps)}
        if args.control:
            f32_exact()
            prompts, served = loop.checked
            row["reference_int8"] = summary(
                ref_dsv2.control_gaps(loop.tree, loop.c, prompts, served, quant.int8))
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
