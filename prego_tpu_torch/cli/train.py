"""Recognition eval entry point (port of prego_tpu/cli/train.py, --eval).

  python -m prego_tpu_torch.cli.train --config configs/miniroad_assembly101-O.yaml \
      --eval path/to/best.ckpt [--eval_output_dir DIR] [--device cuda]

Reads the JAX package's checkpoint format (checkpoint/io.py), runs the
streaming evaluator and exports the per-frame prediction JSON in the
reference's schema. Training is not ported yet (ROADMAP M8): without
--eval the command raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Dict, List, Optional, Tuple

import torch

from prego_tpu.data import load_dataset_info, load_feature_store
from prego_tpu_torch.checkpoint import load_params
from prego_tpu_torch.checkpoint.bridge import miniroad_from_numpy
from prego_tpu_torch.core import RecognitionConfig, create_outdir, get_logger, set_seed
from prego_tpu_torch.core.registry import MODELS
from prego_tpu_torch.train.evaluator import Evaluator


def default_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_eval(cfg: RecognitionConfig, device: str) -> Tuple[float, Dict]:
    """The --eval path: load the test split and the checkpoint named by
    ``cfg.eval``, score every video, export the JSON. Returns (mAP, result)."""
    if cfg.task != "OAD":
        raise NotImplementedError(
            f"task {cfg.task!r}: the port evaluates the OAD task only "
            "(ANTICIPATION and MiniROADA are ROADMAP M9)"
        )
    set_seed(cfg.seed)
    info = load_dataset_info(cfg.video_list_path, cfg.data_name)
    identifier = f"{cfg.model}_{cfg.data_name}_{cfg.feature_pretrained}_flow{not cfg.no_flow}"
    result_path = create_outdir(osp.join(cfg.output_path, identifier))
    logger = get_logger(result_path)
    logger.info(str(cfg.to_dict()))
    logger.info(f"device: {device}")
    test_store = load_feature_store(
        root_path=cfg.root_path, vids=info.test_session_set, rgb_type=cfg.rgb_type,
        flow_type=cfg.flow_type, annotation_type=cfg.annotation_type,
        num_classes=cfg.num_classes, training=False, window_size=cfg.window_size,
        logger=logger,
    )
    model = MODELS.get(cfg.model)(cfg)
    evaluator = Evaluator(cfg, info.class_index, logger=logger)
    params = miniroad_from_numpy(load_params(cfg.eval), device=device, dtype=torch.float32)
    export = osp.join(cfg.eval_output_dir, cfg.eval_output_name)
    mAP, result = evaluator(model, params, test_store, export_json=export)
    logger.info(f"per-frame predictions exported to {export}")
    logger.info(f"{cfg.task} result: {mAP * 100:.2f} m{cfg.metric}")
    return mAP, result


def main(argv: Optional[List[str]] = None) -> float:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda | cpu (default: cuda if present)")
    args, overrides = parser.parse_known_args(argv)
    cfg = RecognitionConfig.from_yaml(args.config, overrides)
    if cfg.eval is None or args.resume:
        raise NotImplementedError(
            "training is not ported to PyTorch yet (ROADMAP M8); "
            "run with --eval <checkpoint>, or train with prego_tpu.cli.train"
        )
    mAP, _ = run_eval(cfg, args.device or default_device())
    return mAP


if __name__ == "__main__":
    main()
