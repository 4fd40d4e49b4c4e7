"""The readings that set the limits of a training cell, on the card at the
cell's own size, all seeds in one process (training's readings need no
window: set-up drives the step through its first three steps).

For each seed, each side's numbers against the float32 reference
(``reference/miniroad.py::compare``):
  program      the port's step, as set-up drove it (a sound run)
  bf16         the control: the reference computed in bfloat16
  tf32         the reference with TF32 products (read for PERF.md)
  half_batch   the fault of half the batch left out, the mean over the
               rest, planted in the reference put in the program's place
(a state left unchanged reads 1 on ``change3`` and needs no run).

    python3 perf_bench/tools/limits_train.py --workload train-miniroad-asm101 \
        --seeds 11,12,13 --out build/limits_train.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perf_bench import spec
    from perf_bench.reference import f32_exact
    from perf_bench.reference import miniroad as ref

    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        loop = spec.loop(cell.traffic["loop"]).Loop(cell, seed, dev)
        loop.setup()
        setup_s = time.perf_counter() - t0
        loop.release()
        try:
            f32_exact()
            r = loop.reference()
            cfg = loop.cfg
            batches = ref.first_batches(loop.root, cfg.rgb_type, loop.vids, cfg.window_size,
                                        cfg.stride, cfg.batch_size, 3, cfg.seed)

            def variant(**kw):
                return ref.train(loop.p0, batches, cfg.seed + 1, 1.0 - cfg.dropout, cfg.lr,
                                 cfg.weight_decay, loop.rc["rgb_dim"], **kw)

            row = {"seed": seed, "setup_s": setup_s}
            row["program"], row["program_where"] = ref.compare(loop.program_side(), r, loop.p0)
            row["bf16"], _ = ref.compare(variant(dtype=torch.bfloat16), r, loop.p0)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            row["tf32"], _ = ref.compare(variant(), r, loop.p0)
            f32_exact()
            row["half_batch"], _ = ref.compare(variant(rows=cfg.batch_size // 2), r, loop.p0)
            row["losses"] = r["losses"]
        finally:
            loop.close()
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del loop
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
