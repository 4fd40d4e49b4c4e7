"""Train step and epoch loop (port of prego_tpu/train/trainer.py).

Parity surface: train_one_epoch (step_recognition/trainer/train.py:5-29) and
the optimizer setup in main.py:60-67 (AdamW, lr 1e-4, weight decay 0.05,
torch defaults b1=0.9 b2=0.999 eps=1e-8, decay applied to all params).

``torch.optim.AdamW`` makes optax.adamw's update to rounding: decoupled
decay, p <- p - lr (adam + wd p). Parameters are the model's tensor dict,
updated in place by the optimizer; its state is keyed by those tensors.
The learning rate follows ``schedule(count)`` with count the number of
updates made before this one, as optax counts it. A partial batch is
padded by the sampler and masked out of the loss by ``valid``.

Nothing here falls back: a kernel that fails to build or to launch
raises out of the step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from prego_tpu_torch.checkpoint.io import tree_leaves
from prego_tpu_torch.core.registry import TRAINERS
from prego_tpu_torch.data.windowing import WindowSampler
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.train.loss import last_frame_mlce


def build_optimizer(cfg, params) -> torch.optim.Optimizer:
    leaves = tree_leaves(params)
    if cfg["optimizer"] == "AdamW":
        return torch.optim.AdamW(
            leaves, lr=cfg["lr"], betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg["weight_decay"]
        )
    if cfg["optimizer"] == "Adam":
        return torch.optim.Adam(leaves, lr=cfg["lr"], betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {cfg['optimizer']!r}")


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (optax's ``count``)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def make_train_step(
    model: MiniROAD, optimizer: torch.optim.Optimizer, flow_is_zero: bool,
    bf16: bool = False, gru_backend: str = "scan",
    schedule: Optional[Callable[[int], float]] = None,
) -> Callable[..., torch.Tensor]:
    """The train step: (params, rgb, flow, target_last, valid, generator)
    -> loss. Forward, masked loss, backward, and one optimizer update with
    the scheduled lr; params are updated in place."""

    def step(params, rgb, flow, target_last, valid, generator) -> torch.Tensor:
        if bf16:
            rgb = rgb.to(torch.bfloat16)
            flow = None if flow is None else flow.to(torch.bfloat16)
        if schedule is not None:
            lr = schedule(update_count(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits = model.forward_train(
            params, rgb, flow, generator, flow_is_zero=flow_is_zero, backend=gru_backend
        )
        loss = last_frame_mlce(logits.float(), target_last, valid)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


@TRAINERS.register("OAD")
def train_one_epoch(
    sampler: WindowSampler,
    model: MiniROAD,
    train_step: Callable[..., torch.Tensor],
    params,
    generator: Optional[torch.Generator],
    batch_size: int,
    epoch: int,
    np_rng: Optional[np.random.Generator] = None,
    writer=None,
    log_every: int = 50,
    logger=None,
    stats: Optional[dict] = None,
) -> float:
    """One epoch over the sampler's windows, shuffled by ``np_rng``; params
    and the optimizer are updated in place. Returns the mean loss. With a
    ``stats`` dict, adds the steps, windows and seconds of the loop to it."""
    device = tree_leaves(params)[0].device
    epoch_loss = 0.0
    n_batches = n_windows = 0
    t0 = time.perf_counter()
    for it, batch in enumerate(sampler.iter_batches(batch_size, shuffle=True, rng=np_rng)):
        rgb = torch.from_numpy(batch.rgb).to(device)
        flow = None if sampler.store.flow_is_zero else torch.from_numpy(batch.flow).to(device)
        loss = train_step(
            params, rgb, flow,
            torch.from_numpy(np.ascontiguousarray(batch.target[:, -1, :])).to(device),
            torch.from_numpy(batch.valid).to(device),
            generator,
        )
        loss = float(loss)
        epoch_loss += loss
        n_batches += 1
        n_windows += int(batch.valid.sum())
        if writer is not None:
            writer.add_scalar("Train Loss", loss, it + epoch * sampler.num_batches(batch_size))
        if logger is not None and it % log_every == 0:
            logger.info(f"epoch {epoch} it {it} loss {loss:.4f}")
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + n_batches
        stats["windows"] = stats.get("windows", 0) + n_windows
        stats["seconds"] = stats.get("seconds", 0.0) + time.perf_counter() - t0
    return epoch_loss / max(n_batches, 1)
