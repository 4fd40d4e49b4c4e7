"""The readings that set the limits of a cell that serves the LLM (the
anticipation and online cells), on the card at the cell's own size, all
seeds in one process.

For each seed: a sound run of the program (set-up, a window of
``--seconds``, the check's sample against the float32 reference), then the
controls on the same prompts and served tokens, each read as the gap of
the token that the lower precision puts first:
  program_int8x8  the port's own int8 x int8 path (``quantize_params(...,
                  activations=True)``, teacher-forced through ``forward``)
  reference_int8x8  the plain reference computing every product in int8
and, for the online cell, the recognizer's control: the reference
recognizer in bfloat16, the share of frames whose class differs from the
float32 reference's (``recognizer_bf16_id_mismatch``).

    python3 perf_bench/tools/limits_anticipate.py --workload anticipate-mistral7b \
        --seeds 11,12,13 --seconds 12 --control --out build/limits.jsonl

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


def program_int8x8_gaps(loop, prompts, served):
    import torch

    from perf_bench.loops.anticipate import llama_config
    from perf_bench.reference import llama as ref_llama
    from prego_tpu_torch.models.llama.model import (
        forward, init_cache, precompute_rope, quantize_params,
    )

    cfg = llama_config(loop.c, {**loop.t, "max_batch_size": 1})
    qtree = quantize_params(loop.tree, activations=True)
    rope = precompute_rope(cfg, device=loop.device)
    seqs = [list(p) + list(s) for p, s in zip(prompts, served)]
    positions = [[len(p) - 1 + j for j in range(len(s))] for p, s in zip(prompts, served)]
    ref = ref_llama.logits_at(loop.tree, loop.c, seqs, positions)
    out = []
    with torch.no_grad():
        for seq, pos, r in zip(seqs, positions, ref):
            cache = init_cache(cfg, 1, dtype=loop.tree["norm"].dtype, device=loop.device)
            toks = torch.as_tensor(seq, device=loop.device)[None]
            logits, _ = forward(qtree, toks, 0, cache, cfg, rope)
            pick = logits[0, pos].argmax(dim=-1)
            out.append((r.max(dim=-1).values - r.gather(1, pick[:, None])[:, 0]).tolist())
    del qtree
    return out


def summary(gaps):
    """The mean gap (the number compared), the widest, the share of tokens
    whose gap is not 0, and the count."""
    flat = [g for r in gaps for g in r]
    return {"mean": sum(flat) / len(flat), "widest": max(flat),
            "moved": sum(g > 0 for g in flat) / len(flat), "tokens": len(flat)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perf_bench import spec
    from perf_bench.reference import f32_exact, quant
    from perf_bench.reference import llama as ref_llama

    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        loop = spec.loop(cell.traffic["loop"]).Loop(cell, seed, dev)
        loop.setup()
        loop.window(args.seconds)
        loop.release()
        checks = {c.name: c.value for c in loop.check()}
        row = {"seed": seed, "checks": checks, "units": len(loop.unit_seconds),
               "window_s": loop.window_s, "end_to_end": loop.end_to_end(),
               "program": summary(loop.gaps)}
        if args.control:
            f32_exact()
            prompts, served = loop.checked
            if hasattr(loop, "reference_ids"):  # the recognizer's control: bf16
                f32 = loop.reference_ids()
                low = loop.reference_ids(torch.bfloat16)
                row["recognizer_bf16_id_mismatch"] = (
                    sum(int((a != b).sum()) for a, b in zip(f32, low))
                    / sum(a.numel() for a in f32))
            sim = ref_llama.control_gaps(loop.tree, loop.c, prompts, served, quant.int8)
            prog = program_int8x8_gaps(loop, prompts, served)
            row["reference_int8x8"] = summary(sim)
            row["program_int8x8"] = summary(prog)
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
