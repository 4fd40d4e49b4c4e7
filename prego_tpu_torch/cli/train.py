"""Recognition train/eval entry point (port of prego_tpu/cli/train.py).

  train:  python -m prego_tpu_torch.cli.train --config configs/miniroad_assembly101-O.yaml
  eval:   python -m prego_tpu_torch.cli.train --config ... --eval path/to/best.ckpt
  options: [--resume CKPT] [--device cuda|cpu] [--eval_output_dir DIR] [--<key> value]
  e.g.:   --data_backend native | --model MiniROADA --task ANTICIPATION
          --loss ANTICIPATION --anticipation_length L | --model Transformer

Runs on the card unless ``--device cpu`` asks for the CPU; without a card
and without that flag it raises. Behavior kept from the JAX CLI: YAML +
CLI merge (CLI wins), set_seed, per-epoch window resampling, the
evaluator after every epoch, best-checkpoint save on mAP improvement and
the best_{mAP}.ckpt rename at the end, the same log lines, and on --eval
the per-frame prediction JSON in the reference's schema. Checkpoints are
the JAX package's format both ways (checkpoint/io.py, checkpoint/bridge.py):
``prego_tpu.cli.train --resume`` takes the port's, and the port's
``--resume`` takes the JAX package's, for every registered model
(MiniROAD, MiniROADA, Transformer).

Tasks dispatch as the reference's build_trainer / build_eval registries
do: OAD trains on the last frame's label and evaluates with
``Evaluator``; ANTICIPATION (with MiniROADA) trains on the next L frames'
labels and evaluates with ``AntEvaluator``. ``data_backend: native``
reads the splits through the C++ mmap store (built with g++ on first use;
a failed build raises, nothing falls back to numpy), and on the card
hands training batches over in pinned host memory. As in the JAX CLI,
ANTICIPATION training on the native backend is refused.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from prego_tpu_torch.checkpoint import load_checkpoint, load_params, save_checkpoint
import prego_tpu_torch.models  # noqa: F401  (fills the MODELS registry)
from prego_tpu_torch.checkpoint.bridge import (
    adam_from_optax,
    adam_to_optax,
    recognizer_from_numpy,
    to_numpy_tree,
)
from prego_tpu_torch.checkpoint.io import tree_leaves
from prego_tpu_torch.core import (
    RecognitionConfig,
    create_outdir,
    get_logger,
    make_generator,
    resolve_device,
    set_seed,
)
from prego_tpu_torch.core.registry import EVALUATORS, MODELS, TRAINERS
from prego_tpu_torch.data import (
    AnticipationWindowSampler,
    NativeRecognitionData,
    NativeWindowSampler,
    WindowSampler,
    load_dataset_info,
    load_feature_store,
)
from prego_tpu_torch.train import (
    build_optimizer,
    make_ant_train_step,
    make_train_step,
    warmup_cosine_schedule,
)

TASKS = ("OAD", "ANTICIPATION")
DATA_BACKENDS = ("numpy", "native")


def _check(cfg: RecognitionConfig) -> str:
    """The task and the data backend are known; returns the backend."""
    if cfg.task not in TASKS:
        raise ValueError(f"task {cfg.task!r}: expected one of {TASKS}")
    backend = cfg.get("data_backend", "numpy")
    if backend not in DATA_BACKENDS:
        raise ValueError(f"data_backend {backend!r}: expected one of {DATA_BACKENDS}")
    return backend


def _load_store(backend: str, vids, training: bool, common: dict):
    """One split on the numpy backend (FeatureStore, in host RAM) or the
    native one (NativeRecognitionData, mmap'd; raises if its library does
    not build)."""
    if backend == "native":
        return NativeRecognitionData(vids=list(vids), training=training, **common)
    return load_feature_store(vids=vids, training=training, **common)


def _setup(cfg: RecognitionConfig, device: torch.device):
    """Seed, dataset info, output directory and logger (shared by eval and
    train). Returns (info, result_path, logger, common store kwargs)."""
    set_seed(cfg.seed)
    info = load_dataset_info(cfg.video_list_path, cfg.data_name)
    identifier = f"{cfg.model}_{cfg.data_name}_{cfg.feature_pretrained}_flow{not cfg.no_flow}"
    result_path = create_outdir(osp.join(cfg.output_path, identifier))
    logger = get_logger(result_path)
    logger.info(str(cfg.to_dict()))
    logger.info(f"device: {device}")
    common = dict(
        root_path=cfg.root_path, rgb_type=cfg.rgb_type, flow_type=cfg.flow_type,
        annotation_type=cfg.annotation_type, num_classes=cfg.num_classes,
        window_size=cfg.window_size, logger=logger,
    )
    return info, result_path, logger, common


def run_eval(cfg: RecognitionConfig, device) -> Tuple[float, Dict]:
    """The --eval path: load the test split and the checkpoint named by
    ``cfg.eval``, score every video, and for OAD export the JSON. Returns
    (mAP, result); for ANTICIPATION the mAP is the mean anticipation mAP."""
    backend = _check(cfg)
    device = resolve_device(device)
    info, _, logger, common = _setup(cfg, device)
    test_store = _load_store(backend, info.test_session_set, False, common)
    model = MODELS.get(cfg.model)(cfg)
    evaluator = EVALUATORS.get(cfg.task)(cfg, info.class_index, logger=logger)
    params = recognizer_from_numpy(load_params(cfg.eval), device=device, dtype=torch.float32)
    if cfg.task == "ANTICIPATION":
        mAP, result = evaluator(model, params, test_store)
    else:
        export = osp.join(cfg.eval_output_dir, cfg.eval_output_name)
        mAP, result = evaluator(model, params, test_store, export_json=export)
        logger.info(f"per-frame predictions exported to {export}")
    logger.info(f"{cfg.task} result: {mAP * 100:.2f} m{cfg.metric}")
    return mAP, result


@dataclass
class TrainResult:
    best_mAP: float
    best_epoch: int
    ckpt_path: Optional[str]  # the renamed best_{mAP}.ckpt, None if no epoch improved
    epoch_losses: List[float] = field(default_factory=list)
    epoch_mAPs: List[float] = field(default_factory=list)
    stats: Dict = field(default_factory=dict)  # steps, windows, seconds of the train loops


def run_train(cfg: RecognitionConfig, device, resume: Optional[str] = None) -> TrainResult:
    """Train from ``cfg`` (or from the checkpoint ``resume``), evaluating
    after every epoch and keeping the best checkpoint."""
    backend = _check(cfg)
    ant = cfg.task == "ANTICIPATION"
    if ant and backend == "native":  # as prego_tpu/cli/train.py:130-131
        raise SystemExit("ANTICIPATION training uses the numpy data backend")
    device = resolve_device(device)
    info, result_path, logger, common = _setup(cfg, device)
    test_store = _load_store(backend, info.test_session_set, False, common)
    model = MODELS.get(cfg.model)(cfg)
    evaluator = EVALUATORS.get(cfg.task)(cfg, info.class_index, logger=logger)

    train_store = _load_store(backend, info.train_session_set, True, common)
    if backend == "native":  # batches in pinned host memory for the card
        sampler = NativeWindowSampler(train_store, cfg.window_size, cfg.stride, device=device)
    elif ant:
        sampler = AnticipationWindowSampler(train_store, cfg.window_size, cfg.stride,
                                            cfg.anticipation_length)
    else:
        sampler = WindowSampler(train_store, cfg.window_size, cfg.stride)
    np_rng = np.random.default_rng(cfg.seed)
    sampler.resample(np_rng)

    schedule = (
        warmup_cosine_schedule(cfg.lr, cfg.num_epoch * sampler.num_batches(cfg.batch_size))
        if cfg.lr_scheduler
        else None
    )
    ckpt = load_checkpoint(resume) if resume else None
    # a fresh init is drawn on the CPU from the seed: the same weights on every device
    host_params = (
        ckpt["params"] if ckpt is not None else to_numpy_tree(model.init(make_generator(cfg.seed)))
    )
    params = recognizer_from_numpy(host_params, device=device, dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    start_epoch = 1
    # the dropout stream: a generator on the device, apart from the init's
    generator = make_generator(cfg.seed + 1, device)
    optimizer = build_optimizer(cfg, params)
    if ckpt is not None:
        if ckpt["opt_state"] is not None:
            adam_from_optax(optimizer, params, ckpt["opt_state"])
        start_epoch = int(ckpt["epoch"]) + 1
        extra = ckpt.get("extra") or {}
        if extra.get("torch_rng_device") == device.type:
            generator.set_state(torch.from_numpy(np.asarray(extra["torch_rng"], np.uint8)))
        else:
            logger.info("no dropout generator state for this device in the checkpoint: "
                        f"the dropout stream restarts from seed {cfg.seed + 1}")
        logger.info(f"resumed from {resume} at epoch {start_epoch}")
    train_step = (make_ant_train_step if ant else make_train_step)(
        model, optimizer, flow_is_zero=train_store.flow_is_zero, bf16=cfg.amp,
        gru_backend=cfg.get("train_gru_backend", "scan"), schedule=schedule,
    )
    epoch_fn = TRAINERS.get(cfg.task)

    n_params = sum(p.numel() for p in tree_leaves(params))
    logger.info(f"Dataset: {cfg.data_name},  Model: {cfg.model}")
    logger.info(
        f"lr:{cfg.lr} | Weight Decay:{cfg.weight_decay} | Window Size:{cfg.window_size} "
        f"| Batch Size:{cfg.batch_size}"
    )
    logger.info(
        f"Total epoch:{cfg.num_epoch} | Total Params:{n_params / 1e6:.1f} M "
        f"| Optimizer: {cfg.optimizer}"
    )
    logger.info(f"Output Path:{result_path}")

    writer = None
    if cfg.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(osp.join(result_path, "runs"))
        except Exception as e:  # tensorboard optional
            logger.info(f"tensorboard unavailable: {e}")

    result = TrainResult(best_mAP=0.0, best_epoch=0, ckpt_path=None)
    ckpt_path = osp.join(result_path, "ckpts", "best.ckpt")
    for epoch in range(start_epoch, cfg.num_epoch + 1):
        t0 = time.perf_counter()
        epoch_loss = epoch_fn(
            sampler, model, train_step, params, generator, cfg.batch_size, epoch,
            np_rng=np_rng, logger=logger, writer=writer, stats=result.stats,
        )
        sampler.resample(np_rng)  # redraw window offsets (main.py:100)
        mAP, _ = evaluator(model, params, test_store)
        result.epoch_losses.append(epoch_loss)
        result.epoch_mAPs.append(mAP)
        if writer is not None:
            writer.add_scalar("Eval mAP", mAP, epoch)
        logger.info(
            f"Epoch {epoch} mAP: {mAP * 100:.2f} | loss {epoch_loss:.4f} "
            f"| {time.perf_counter() - t0:.1f}s"
        )
        if mAP > result.best_mAP:
            result.best_mAP, result.best_epoch = mAP, epoch
            save_checkpoint(
                ckpt_path, params, adam_to_optax(optimizer, params, schedule is not None),
                epoch, rng=None,
                extra={"torch_rng": generator.get_state().numpy(),
                       "torch_rng_device": generator.device.type},
            )
            logger.info(
                f"Checkpoint Saved at {ckpt_path} | Best mAP: {result.best_mAP * 100:.2f} "
                f"at epoch {result.best_epoch}"
            )

    if osp.exists(ckpt_path):
        result.ckpt_path = osp.join(result_path, "ckpts", f"best_{result.best_mAP * 100:.2f}.ckpt")
        os.rename(ckpt_path, result.ckpt_path)
    return result


def main(argv: Optional[List[str]] = None) -> float:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument(
        "--resume", type=str, default=None,
        help="checkpoint to resume training from (params+opt_state+epoch)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda | cpu (default cuda; raises where there is no card)")
    args, overrides = parser.parse_known_args(argv)
    cfg = RecognitionConfig.from_yaml(args.config, overrides)
    if cfg.eval is not None:
        mAP, _ = run_eval(cfg, args.device)
        return mAP
    return run_train(cfg, args.device, resume=args.resume).best_mAP


if __name__ == "__main__":
    main()
