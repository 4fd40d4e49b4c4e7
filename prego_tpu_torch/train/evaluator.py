"""Full-video streaming evaluation + per-frame prediction export (port of
prego_tpu/train/evaluator.py).

Parity surface: Evaluate (step_recognition/trainer/eval.py:15-84):
strictly-causal per-frame softmax scores over each full test video; on
--eval the argmax pred/gt int lists per video are dumped to
output_miniROAD.json (eval.py:50-65); per-frame mAP; frames/sec.

As in the JAX package, test videos are evaluated in groups of up to 64,
each group streamed through the model in fixed time chunks (2048 frames)
with the GRU state carried from chunk to chunk; h0 is zero per video and
the recurrence is batch-independent, so per-frame outputs equal a
batch-1 eval. Chunks are gathered from the host store just before their
dispatch, so host memory holds one (V, chunk, D) slab at a time.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from prego_tpu_torch.data.features import FeatureStore
from prego_tpu_torch.metrics.perframe import perframe_average_precision
from prego_tpu_torch.core.registry import EVALUATORS
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.ops.gru import gru_scan
from prego_tpu_torch.ops.gru_cuda import gru_layer


def make_chunk_fn(model: MiniROAD, flow_is_zero: bool, backend: str = "scan"):
    """Chunk forward: (params, rgb (B, C, Dr), flow, hidden) -> (softmax
    scores, hidden).

    backend 'kernel' (the JAX config's ``gru_backend: pallas``) runs the
    fused recurrence K1 with bf16 streaming; 'scan' is the f32 reference
    recurrence, used on the CPU and in numerics tests. A CUDA tensor always
    takes the kernel."""

    @torch.no_grad()
    def chunk_fn(params, rgb, flow, hidden):
        x = model._embed(params, rgb, flow, flow_is_zero=flow_is_zero)
        new_hidden = []
        h_seq = x
        for layer_params, h0 in zip(params["gru"], hidden):
            if backend == "kernel" or x.is_cuda:
                h_seq, hT = gru_layer(h_seq, h0, layer_params, stream_dtype=torch.bfloat16)
            else:
                h_seq, hT = gru_scan(h_seq, h0, layer_params)
            new_hidden.append(hT)
        return torch.softmax(model._classify(params, h_seq), dim=-1), tuple(new_hidden)

    return chunk_fn


def _device_of(params) -> torch.device:
    return params["embed"]["w"].device


def streaming_scores(
    model: MiniROAD, params, rgb: np.ndarray, flow: np.ndarray, flow_is_zero: bool,
    chunk_size: int = 2048, chunk_fn=None, backend: str = "scan",
) -> np.ndarray:
    """Causal scores for a padded batch (V, T, D) -> (V, T, K), chunked over time."""
    device = _device_of(params)
    V, T = rgb.shape[0], rgb.shape[1]
    if chunk_fn is None:
        chunk_fn = make_chunk_fn(model, flow_is_zero, backend=backend)
    hidden = model.init_hidden(V, device=device)
    outs = []
    for t0 in range(0, T, chunk_size):
        t1 = min(t0 + chunk_size, T)
        r = torch.from_numpy(np.ascontiguousarray(rgb[:, t0:t1])).to(device)
        f = torch.from_numpy(np.ascontiguousarray(flow[:, t0:t1])).to(device)
        scores, hidden = chunk_fn(params, r, f, hidden)
        outs.append(scores.cpu().numpy())
    return np.concatenate(outs, axis=1)


def streaming_scores_lazy(
    model: MiniROAD, params, store: FeatureStore, vids: List[str],
    chunk_size: int = 2048, chunk_fn=None, backend: str = "scan",
) -> List[np.ndarray]:
    """Causal scores per video without materialising a padded (V, Tmax, D)
    batch: each time chunk is gathered from the store just before its
    dispatch. Returns a list of (T_v, K) arrays aligned with ``vids``.

    Unlike the JAX version the trailing chunk is not padded to the chunk
    size (PyTorch compiles nothing per shape), and with a zero flow stream
    no flow tensor is built at all."""
    device = _device_of(params)
    V = len(vids)
    lengths = np.array([store.length(v) for v in vids], np.int64)
    Tmax = int(lengths.max())
    if chunk_fn is None:
        chunk_fn = make_chunk_fn(model, store.flow_is_zero, backend=backend)
    hidden = model.init_hidden(V, device=device)
    per_chunk: List[np.ndarray] = []
    for t0 in range(0, Tmax, chunk_size):
        C = min(chunk_size, Tmax - t0)
        r = np.zeros((V, C, store.rgb_dim), np.float32)
        f = None if store.flow_is_zero else np.zeros((V, C, store.flow_dim), np.float32)
        for i, v in enumerate(vids):
            t1v = min(t0 + C, int(lengths[i]))
            if t1v > t0:
                r[i, : t1v - t0] = store.rgb[v][t0:t1v]
                if f is not None:
                    f[i, : t1v - t0] = store.flow[v][t0:t1v]
        r_dev = torch.from_numpy(r).to(device, non_blocking=False)
        f_dev = None if f is None else torch.from_numpy(f).to(device)
        scores, hidden = chunk_fn(params, r_dev, f_dev, hidden)
        per_chunk.append(scores.cpu().numpy())
    return [
        np.concatenate([c[i] for c in per_chunk], axis=0)[: int(lengths[i])]
        for i in range(V)
    ]


@EVALUATORS.register("OAD")
class Evaluator:
    def __init__(self, cfg, class_names: List[str], logger=None):
        self.cfg = cfg
        self.class_names = class_names
        self.metric = cfg["metric"]
        self.logger = logger
        if "THUMOS" in cfg["data_name"]:
            from prego_tpu_torch.metrics.postprocessing import thumos_postprocessing

            self.postprocessing = thumos_postprocessing
        else:
            self.postprocessing = None  # the PREGO datasets (eval.py:20-22)

    def __call__(
        self, model: MiniROAD, params, store: FeatureStore,
        export_json: Optional[str] = None, chunk_size: int = 2048, video_batch: int = 64,
    ) -> Tuple[float, Dict]:
        """Evaluate in groups of ``video_batch`` videos; within a group,
        time chunks are gathered from the store lazily. ``result["fps"]``
        counts frames over the wall time of the scoring loop."""
        backend = "kernel" if self.cfg.get("gru_backend", "scan") == "pallas" else "scan"
        all_vids = list(store.vids)
        device = _device_of(params)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_start = time.perf_counter()
        per_video_scores: Dict[str, np.ndarray] = {}
        for g0 in range(0, len(all_vids), video_batch):
            group = all_vids[g0 : g0 + video_batch]
            group_scores = streaming_scores_lazy(
                model, params, store, group, chunk_size=chunk_size, backend=backend,
            )
            per_video_scores.update(zip(group, group_scores))
        elapsed = time.perf_counter() - t_start  # scores are on the host: synced

        pred_scores, gt_targets = [], []
        output = {}
        lengths = np.array([store.length(v) for v in all_vids], np.int64)
        for vid in all_vids:
            s = per_video_scores[vid]
            g = store.target[vid]
            pred_scores.append(s)
            gt_targets.append(g)
            output[vid] = {
                "pred": np.argmax(s, axis=1).astype(int).tolist(),
                "gt": np.argmax(g, axis=1).astype(int).tolist(),
            }
        pred_scores = np.concatenate(pred_scores, axis=0)
        gt_targets = np.concatenate(gt_targets, axis=0)

        if export_json is not None:
            os.makedirs(os.path.dirname(export_json) or ".", exist_ok=True)
            with open(export_json, "w") as f:
                json.dump(output, f)

        num_frames = int(lengths.sum())
        if self.logger is not None:
            self.logger.info(
                f"Processed {num_frames} frames in {elapsed:.2f}s "
                f"({num_frames / max(elapsed, 1e-9):.1f} FPS) on {device}"
            )
        result = perframe_average_precision(
            pred_scores, gt_targets, self.class_names, self.postprocessing, self.metric
        )
        result["fps"] = num_frames / max(elapsed, 1e-9)
        result["output"] = output
        return result["mean_AP"], result
