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

A batch from the native sampler comes in pinned host tensors: the loop
copies them with ``non_blocking`` on a side stream and marks the batch
copied, so that the sampler's ring can reuse the buffers once the copies
have run. A numpy batch is copied as before (pageable, so the copy waits
for the host and for the stream).

Data parallelism (``make_train_step(mesh=)``, the JAX package's
``mesh`` argument): every rank holds the same parameters and optimizer
state, takes its block of the batch along the mesh's ``dp`` axis and runs
the step on it (K1 and K6 per rank on the card). The masked mean of the
loss is the global one: each rank's masked sum is divided by the valid
count summed over the ranks (a mean of per-rank means is wrong when the
counts differ), the gradients are all-reduced (summed), and the same
optimizer update follows on every rank; the step returns the global loss.

Nothing here falls back: a kernel that fails to build or to launch
raises out of the step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from prego_tpu_torch.checkpoint.io import tree_leaves
from prego_tpu_torch.core.registry import TRAINERS
from prego_tpu_torch.data.windowing import AnticipationWindowSampler
from prego_tpu_torch.train.loss import anticipation_mlce, last_frame_mlce


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


def _make_step(model, optimizer, flow_is_zero, bf16, gru_backend, schedule, loss_of,
               mesh=None):
    dp = n_dp = None
    if mesh is not None:
        dp, n_dp, i_dp = mesh.group("dp"), mesh.shape["dp"], mesh.index("dp")

    def step(params, rgb, flow, target, valid, generator) -> torch.Tensor:
        if dp is not None:  # this rank's block of the batch
            if rgb.shape[0] % n_dp:
                raise ValueError(f"batch of {rgb.shape[0]} does not split over dp {n_dp}")
            b = rgb.shape[0] // n_dp
            rgb, target, valid = (x[i_dp * b:(i_dp + 1) * b] for x in (rgb, target, valid))
            flow = None if flow is None else flow[i_dp * b:(i_dp + 1) * b]
        if bf16:
            rgb = rgb.to(torch.bfloat16)
            flow = None if flow is None else flow.to(torch.bfloat16)
        if schedule is not None:
            lr = schedule(update_count(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        out = model.forward_train(
            params, rgb, flow, generator, flow_is_zero=flow_is_zero, backend=gru_backend
        )
        loss = loss_of(out, target, valid)
        if dp is not None:
            # the local masked mean times count / global count: this rank's
            # share of the global masked mean
            count = valid.sum()
            total = count.detach().clone()
            dist.all_reduce(total, group=dp)
            loss = loss * torch.clamp(count, min=1.0) / torch.clamp(total, min=1.0)
        loss.backward()
        if dp is not None:
            for g in optimizer.param_groups:
                for p in g["params"]:
                    if p.grad is not None:
                        dist.all_reduce(p.grad, group=dp)
            loss = loss.detach()
            dist.all_reduce(loss, group=dp)
        optimizer.step()
        return loss.detach()

    return step


def make_train_step(
    model, optimizer: torch.optim.Optimizer, flow_is_zero: bool,
    bf16: bool = False, gru_backend: str = "scan",
    schedule: Optional[Callable[[int], float]] = None, mesh=None,
) -> Callable[..., torch.Tensor]:
    """The train step: (params, rgb, flow, target_last, valid, generator)
    -> loss. Forward, masked loss, backward, and one optimizer update with
    the scheduled lr; params are updated in place. With a ``mesh``
    (``parallel.make_mesh`` with a ``dp`` axis), the batch given is the
    global one and each rank steps on its block of it (see above)."""
    return _make_step(model, optimizer, flow_is_zero, bf16, gru_backend, schedule,
                      lambda logits, target, valid: last_frame_mlce(logits.float(), target, valid),
                      mesh)


def make_ant_train_step(
    model, optimizer: torch.optim.Optimizer, flow_is_zero: bool, bf16: bool = False,
    gru_backend: str = "scan", schedule: Optional[Callable[[int], float]] = None,
) -> Callable[..., torch.Tensor]:
    """The ANTICIPATION-task train step (trainer/train.py:31-54 +
    criterions/loss.py:40-79): (params, rgb, flow, ant_target, valid,
    generator) -> loss, the sum-reduced anticipation loss on the last
    window frame's predicted future steps; otherwise as ``make_train_step``
    (the GRU on a CUDA tensor is K1 + K6 here too)."""
    return _make_step(model, optimizer, flow_is_zero, bf16, gru_backend, schedule,
                      lambda out, target, valid: anticipation_mlce(out[1].float(), target, valid))


def to_device(x, device: torch.device) -> torch.Tensor:
    """A batch array on ``device``: a numpy array through a pageable copy,
    a pinned tensor (the native sampler's ring) with ``non_blocking``."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device, non_blocking=x.is_pinned())


def _batch_on_device(batch, device, flow_is_zero: bool, targets: Callable):
    """(rgb, flow, target, valid) of ``batch`` on ``device``, then the
    batch marked copied."""
    out = (to_device(batch.rgb, device),
           None if flow_is_zero else to_device(batch.flow, device),
           targets(batch, device), to_device(batch.valid, device))
    if batch.on_copied is not None:
        batch.on_copied()  # the copies are enqueued: the sampler reuses the buffers after them
    return out


def _run_epoch(
    sampler, train_step, params, generator, batch_size: int, epoch: int,
    targets: Callable, np_rng, writer, log_every: int, logger, stats: Optional[dict], label: str,
) -> float:
    """The epoch loop both tasks share: ``targets(batch, device)`` gives
    the step's target tensor. A loss is read from the card only where it
    is logged, and the epoch's at the end, so that the host can enqueue a
    step while the card runs the one before. Pinned batches (the native
    sampler's) are copied on a side stream that the step's stream waits
    for: the copy of batch i+1 runs beside step i."""
    device = tree_leaves(params)[0].device
    flow_is_zero = sampler.store.flow_is_zero
    copy_stream = None
    losses = []
    n_windows = 0
    t0 = time.perf_counter()
    for it, batch in enumerate(sampler.iter_batches(batch_size, shuffle=True, rng=np_rng)):
        if device.type == "cuda" and isinstance(batch.rgb, torch.Tensor) and batch.rgb.is_pinned():
            copy_stream = copy_stream or torch.cuda.Stream(device)
            compute = torch.cuda.current_stream(device)
            with torch.cuda.stream(copy_stream):
                tensors = _batch_on_device(batch, device, flow_is_zero, targets)
            compute.wait_stream(copy_stream)
            for x in tensors:
                if x is not None:
                    x.record_stream(compute)  # allocated on the copy stream, read by the step
        else:
            tensors = _batch_on_device(batch, device, flow_is_zero, targets)
        loss = train_step(params, *tensors, generator)
        losses.append(loss)
        n_windows += int(batch.valid.sum())  # a host array or a pinned tensor: no device read
        if writer is not None:
            writer.add_scalar("Train Loss", float(loss), it + epoch * sampler.num_batches(batch_size))
        if logger is not None and it % log_every == 0:
            logger.info(f"epoch {epoch} it {it} {label} {float(loss):.4f}")
    epoch_loss = sum(torch.stack(losses).cpu().tolist()) if losses else 0.0
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + len(losses)
        stats["windows"] = stats.get("windows", 0) + n_windows
        stats["seconds"] = stats.get("seconds", 0.0) + time.perf_counter() - t0
    return epoch_loss / max(len(losses), 1)


def _last_frame_target(batch, device) -> torch.Tensor:
    if isinstance(batch.target, np.ndarray):
        return to_device(batch.target[:, -1, :], device)
    # a ring tensor: copied whole (contiguous, so non_blocking), sliced on the device
    return to_device(batch.target, device)[:, -1, :].contiguous()


@TRAINERS.register("ANTICIPATION")
def ant_train_one_epoch(
    sampler: AnticipationWindowSampler,
    model,
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
    """One ANTICIPATION epoch (batches carry ``ant_target`` (B, L, K));
    otherwise as ``train_one_epoch``."""
    return _run_epoch(
        sampler, train_step, params, generator, batch_size, epoch,
        lambda batch, device: to_device(batch.ant_target, device),
        np_rng, writer, log_every, logger, stats, "ant loss",
    )


@TRAINERS.register("OAD")
def train_one_epoch(
    sampler,
    model,
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
    """One epoch over the sampler's windows (``WindowSampler`` or
    ``NativeWindowSampler``), shuffled by ``np_rng``; params and the
    optimizer are updated in place. Returns the mean loss. With a
    ``stats`` dict, adds the steps, windows and seconds of the loop to it."""
    return _run_epoch(
        sampler, train_step, params, generator, batch_size, epoch, _last_frame_target,
        np_rng, writer, log_every, logger, stats, "loss",
    )
