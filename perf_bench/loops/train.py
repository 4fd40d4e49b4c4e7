"""Recognizer training: MiniROAD at a dataset recipe, on synthetic
features shaped as the dataset's, as fast as it goes.

Set-up writes the split under the run's temporary directory, then builds
what ``cli/train.py::run_train`` builds on the native data engine (the
store, the sampler with its pinned ring, the optimizer, the train step)
and drives it through its first epoch with ``train/trainer.py::
train_one_epoch``: the warm-up, whose first three steps the check follows.
The window runs further epochs through the same call (the per-epoch
evaluation left out), resampling the windows between epochs as
``run_train`` does.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perf_bench import gen, tracing, weights
from perf_bench.loops import Check, limit_of
from perf_bench.reference import f32_exact
from perf_bench.reference import miniroad as ref

BETA1 = 0.9  # torch's AdamW default, which the port builds


class Probe:
    """The train step, passed through. During set-up it keeps the losses of
    the first three steps, the optimizer's first moments after step 1 and
    the parameters after step 3; in the window it counts steps, keeps
    their losses, and starts and stops a tracer."""

    def __init__(self, step, params, optimizer):
        self.step, self.params, self.optimizer = step, params, optimizer
        self.losses: List[torch.Tensor] = []
        self.first_moment: Optional[Dict[str, torch.Tensor]] = None
        self.after3: Optional[Dict[str, torch.Tensor]] = None
        self.window_losses: List[torch.Tensor] = []
        self.in_window = False
        self.tracer = None
        self.trace_units = 0

    def __call__(self, *args):
        if self.in_window:
            n = len(self.window_losses)
            if self.tracer is not None and n == 0:
                self.tracer.start()
            with tracing.span("step"):
                loss = self.step(*args)
            self.window_losses.append(loss)
            if self.tracer is not None and self.tracer.active and n + 1 == self.trace_units:
                self.tracer.stop()
            return loss
        loss = self.step(*args)
        if len(self.losses) < 3:
            self.losses.append(loss.detach().clone())
            flat = ref.flat(self.params)
            if len(self.losses) == 1:
                # an optimizer that made no update has no moments: zero
                state = self.optimizer.state
                self.first_moment = {
                    k: state[p]["exp_avg"].detach().clone() if "exp_avg" in state.get(p, {})
                    else torch.zeros_like(p.detach()) for k, p in flat.items()}
            if len(self.losses) == 3:
                self.after3 = {k: p.detach().clone() for k, p in flat.items()}
        return loss


class Loop:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.rc = cell.config["recognizer"]
        self.recipe = cell.config["recipe"]
        self.t = cell.traffic
        self.window_s = 0.0
        self.windows = self.steps = 0
        self.attempted = self.failed = 0
        self.trace = None
        self.root = None
        self.unit_seconds: List[float] = []  # each epoch of the window
        self.unit_work: List[int] = []  # its windows

    def _cfg(self):
        from prego_tpu_torch.core import RecognitionConfig

        raw = dict(self.recipe)
        raw.update(root_path=self.root, video_list_path=os.path.join(self.root, "video_list.json"),
                   data_name=self.t["data_name"], output_path=os.path.join(self.root, "out"),
                   data_backend="native", seed=self.seed % (1 << 31))
        return RecognitionConfig.from_dict(raw)

    def setup(self) -> None:
        from prego_tpu_torch.core.registry import MODELS
        from prego_tpu_torch.core.seed import make_generator
        from prego_tpu_torch.data import NativeRecognitionData, NativeWindowSampler
        from prego_tpu_torch.data.video_list import load_dataset_info
        from prego_tpu_torch.train import build_optimizer, make_train_step
        import prego_tpu_torch.models  # noqa: F401  (fills the MODELS registry)

        self.root = tempfile.mkdtemp(prefix="perf_bench_train_")
        rc = self.rc
        gen.write_feature_videos(self.t, self.seed, self.root, rc["rgb_type"],
                                 rc["num_classes"], rc["rgb_dim"])
        cfg = self.cfg = self._cfg()
        info = load_dataset_info(cfg.video_list_path, cfg.data_name)
        self.vids = list(info.train_session_set)
        self.model = MODELS.get(cfg.model)(cfg)
        store = NativeRecognitionData(
            root_path=cfg.root_path, vids=self.vids, rgb_type=cfg.rgb_type,
            flow_type=cfg.flow_type, annotation_type=cfg.annotation_type,
            num_classes=cfg.num_classes, training=True, window_size=cfg.window_size)
        self.sampler = NativeWindowSampler(store, cfg.window_size, cfg.stride,
                                           device=self.device)
        self.np_rng = np.random.default_rng(cfg.seed)
        self.sampler.resample(self.np_rng)
        self.params = weights.miniroad_tree(rc, self.seed, self.device)
        self.p0 = {k: v.detach().clone() for k, v in ref.flat(self.params).items()}
        for p in weights.tree_leaves(self.params):
            p.requires_grad_(True)
        self.generator = make_generator(cfg.seed + 1, self.device)
        self.optimizer = build_optimizer(cfg, self.params)
        step = make_train_step(self.model, self.optimizer, flow_is_zero=store.flow_is_zero,
                               bf16=cfg.amp, gru_backend=cfg.get("train_gru_backend", "scan"))
        self.probe = Probe(step, self.params, self.optimizer)
        self.epoch = 1
        self._epoch({})  # the warm-up: every shape, and the first three steps

    def _epoch(self, stats: dict) -> None:
        from prego_tpu_torch.train.trainer import train_one_epoch

        train_one_epoch(self.sampler, self.model, self.probe, self.params, self.generator,
                        self.cfg.batch_size, self.epoch, np_rng=self.np_rng, stats=stats)
        self.sampler.resample(self.np_rng)  # redraw window offsets, as run_train does
        self.epoch += 1

    def window(self, seconds: float, tracer: Optional[tracing.Tracer] = None) -> None:
        self.probe.in_window = True
        self.probe.tracer = tracer
        self.probe.trace_units = int(self.t["trace_units"])
        t0 = time.perf_counter()
        while True:
            stats: dict = {}
            t = time.perf_counter()
            with tracing.span("epoch"):
                self._epoch(stats)  # ends in a read of the epoch's losses
            self.unit_seconds.append(time.perf_counter() - t)
            self.unit_work.append(int(stats["windows"]))
            self.windows += stats["windows"]
            self.steps += stats["steps"]
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        if tracer is not None and tracer.active:
            tracer.stop()
        self.probe.in_window = False
        self.attempted = self.steps
        losses = torch.stack(self.probe.window_losses).float().cpu().numpy()
        self.failed = int((~np.isfinite(losses)).sum())

    def end_to_end(self) -> dict:
        return {"train_windows_per_s": (self.windows / self.window_s, "windows/s")}

    def release(self) -> None:
        self.sampler = self.optimizer = self.model = None
        self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        """Removes the split set-up wrote."""
        if self.root is not None:
            shutil.rmtree(self.root, ignore_errors=True)
            self.root = None

    def steps_in_trace(self) -> int:
        return min(int(self.t["trace_units"]), len(self.probe.window_losses))

    # ---- correctness ----

    def reference(self, dtype=torch.float32) -> Dict:
        cfg = self.cfg
        batches = ref.first_batches(self.root, cfg.rgb_type, self.vids, cfg.window_size,
                                    cfg.stride, cfg.batch_size, 3, cfg.seed)
        return ref.train(self.p0, batches, cfg.seed + 1, 1.0 - cfg.dropout, cfg.lr,
                         cfg.weight_decay, self.rc["rgb_dim"], dtype=dtype)

    def program_side(self) -> Dict:
        """The program's losses of its first three steps, its first gradient
        (the optimizer's first moment after step 1 over 1 - beta1) and its
        parameters after step 3."""
        pr = self.probe
        return {"losses": [float(x) for x in pr.losses],
                "grad": {k: m / (1 - BETA1) for k, m in pr.first_moment.items()},
                "params": pr.after3}

    def check(self) -> List[Check]:
        f32_exact()
        self.values, self.where = ref.compare(self.program_side(), self.reference(), self.p0)
        lim = self.cell.limits
        return [Check(k, v, limit_of(lim, k)) for k, v in self.values.items()] + [
            Check("failed_steps", float(self.failed), 0.0)]
