"""Full PREGO pipeline in one command:
recognition eval -> per-frame JSON -> aggregation -> anticipation ->
one-class mistake metrics.

The reference spreads this across main.py --eval, utils/aggregate.py and
the per-backend anticipation scripts (run.sh — which points at a path that
does not exist, SURVEY.md §7 quirk table). Here:

  python -m prego_tpu_torch.cli.pipeline --config configs/miniroad_assembly101-O.yaml \
      --ckpt best.ckpt --llm torch-llama --fabricated 7b --dataset synthcustom

This is the port of prego_tpu/cli/pipeline.py, with the same flags plus
--fabricated and --orbax_dir (passed on to anticipate) and --device. --llm
hf and --llm ollama take --model_name, as anticipate does. Under
``python -m torch.distributed.run`` rank 0 runs recognition and
aggregation, and every rank anticipates (see cli/anticipate.py).

Use --skip_recognition with --seqs to start from existing per-frame or
aggregated predictions.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import List, Optional

from prego_tpu_torch.aggregate import aggregate
from prego_tpu_torch.core import get_logger


def aggregate_predictions(raw_path: str, agg_path: str) -> dict:
    """Per-frame predictions JSON -> aggregated step sequences JSON."""
    with open(raw_path) as f:
        return aggregate(json.load(f), agg_path)


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, help="recognition YAML config")
    p.add_argument("--ckpt", type=str, help="recognition checkpoint for eval")
    p.add_argument("--skip_recognition", action="store_true")
    p.add_argument("--seqs", type=str, default=None,
                   help="existing per-frame predictions JSON (with --skip_recognition)")
    p.add_argument("--workdir", type=str, default="pipeline_out")
    p.add_argument("--already_aggregated", action="store_true")
    # anticipation passthroughs
    p.add_argument("--llm", type=str, default="fake")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--data_root", type=str, default="step_anticipation/data")
    p.add_argument("--dataset", type=str, default="assembly")
    p.add_argument("--type_prompt", type=str, default="num")
    p.add_argument("--prompt_context", type=str, default="default")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--max_gen_len", type=int, default=8)
    p.add_argument("--use_gt", action="store_true")
    p.add_argument("--toy_class_context", action="store_true")
    p.add_argument("--fabricated", type=str, default=None,
                   choices=["7b", "13b", "1b", "tiny"],
                   help="torch-llama with random weights at a reference shape")
    p.add_argument("--orbax_dir", type=str, default=None,
                   help="torch-llama: cache of the --ckpt_dir checkpoint's converted weights")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda | cpu (default cuda; raises where there is no card)")
    args = p.parse_args(argv)

    import torch.distributed as dist

    from prego_tpu_torch.parallel.mesh import init_distributed, is_rank0

    logger = get_logger()
    _, world = init_distributed(args.device)  # a launcher's ranks
    if args.skip_recognition:
        if not args.seqs:
            raise SystemExit("--skip_recognition requires --seqs")
        raw_path = args.seqs
    else:
        if not (args.config and args.ckpt):
            raise SystemExit("recognition stage requires --config and --ckpt")
        raw_path = osp.join(args.workdir, "perframe_predictions.json")
    agg_path = raw_path if args.already_aggregated else osp.join(args.workdir, "aggregated.json")

    if is_rank0():  # under ranks, rank 0 alone runs stages 1 and 2
        os.makedirs(args.workdir, exist_ok=True)
        # 1. recognition eval -> per-frame predictions
        if not args.skip_recognition:
            from prego_tpu_torch.cli.train import main as train_main

            train_main(
                [
                    "--config", args.config,
                    "--eval", args.ckpt,
                    "--eval_output_dir", osp.dirname(raw_path),
                    "--eval_output_name", osp.basename(raw_path),
                    "--device", args.device,
                ]
            )
            logger.info(f"[pipeline] recognition predictions -> {raw_path}")
        # 2. aggregation (TI-PREGO consensus)
        if not args.already_aggregated:
            aggregate_predictions(raw_path, agg_path)
            logger.info(f"[pipeline] aggregated step sequences -> {agg_path}")
    if world > 1:
        dist.barrier()  # the aggregated sequences are written

    # 3. anticipation + mistake detection
    from prego_tpu_torch.cli.anticipate import main as anticipate_main

    ant_args = [
        "--llm", args.llm,
        "--seqs", agg_path,
        "--data_root", args.data_root,
        "--dataset", args.dataset,
        "--type_prompt", args.type_prompt,
        "--prompt_context", args.prompt_context,
        "--num_samples", str(args.num_samples),
        "--temperature", str(args.temperature),
        "--top_p", str(args.top_p),
        "--max_gen_len", str(args.max_gen_len),
        "--results_root", osp.join(args.workdir, "results"),
    ]
    if args.use_gt:
        ant_args.append("--use_gt")
    if args.toy_class_context:
        ant_args.append("--toy_class_context")
    if args.model_name:
        ant_args += ["--model_name", args.model_name]
    if args.ckpt_dir:
        ant_args += ["--ckpt_dir", args.ckpt_dir]
    if args.tokenizer_path:
        ant_args += ["--tokenizer_path", args.tokenizer_path]
    if args.fabricated:
        ant_args += ["--fabricated", args.fabricated]
    if args.orbax_dir:
        ant_args += ["--orbax_dir", args.orbax_dir]
    ant_args += ["--device", args.device]
    result = anticipate_main(ant_args)
    logger.info("[pipeline] done")
    return result


if __name__ == "__main__":
    main()
