"""Sliding-window sampling for training and full-video eval indexing (the
port's own copy of prego_tpu/data/windowing.py, numpy only).

Parity surface: THUMOSDataset._init_features
(step_recognition/datasets/dataset.py:96-123):

  * train: per video, draw offset = randint(stride) each epoch, then emit
    windows [start, start+window) for start in range(offset, T, stride)
    while the window fits (dataset.py:113-119). The reference re-calls
    _init_features every epoch (main.py:100) to redraw offsets — here that
    is ``resample(rng)``.
  * test: one full-length window per video (dataset.py:120-123).

Windows are (vid_idx, start) int32 arrays; the batch iterator gathers
feature slices with numpy and pads the trailing partial batch (carrying a
validity mask) so every train step sees one batch shape and the padding
rows are masked out of the loss — the reference instead ships a smaller
final torch batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from prego_tpu_torch.data.features import FeatureStore


@dataclass
class Batch:
    rgb: np.ndarray  # (B, W, D_rgb) float32
    flow: np.ndarray  # (B, W, D_flow) float32
    target: np.ndarray  # (B, W, K) float32
    valid: np.ndarray  # (B,) float32 — 0 for padding rows of a partial batch
    vids: List[str]
    starts: np.ndarray  # (B,) int64
    ends: np.ndarray  # (B,) int64


class WindowSampler:
    """Strided training windows with per-epoch random offsets."""

    def __init__(self, store: FeatureStore, window_size: int, stride: int):
        self.store = store
        self.window_size = window_size
        self.stride = stride
        self.windows: List[Tuple[int, int]] = []

    def resample(self, rng: Optional[np.random.Generator] = None) -> None:
        """Rebuild the window list (call once per epoch, dataset.py:113-119)."""
        rng = rng or np.random.default_rng()
        self.windows = []
        for vi, vid in enumerate(self.store.vids):
            T = self.store.length(vid)
            offset = int(rng.integers(0, self.stride))
            start = offset
            while start + self.window_size <= T:
                self.windows.append((vi, start))
                start += self.stride

    def __len__(self) -> int:
        return len(self.windows)

    def num_batches(self, batch_size: int) -> int:
        return (len(self.windows) + batch_size - 1) // batch_size

    def iter_batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Iterator[Batch]:
        if not self.windows:
            self.resample(rng)
        order = np.arange(len(self.windows))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        W = self.window_size
        store = self.store
        for b0 in range(0, len(order), batch_size):
            idxs = order[b0 : b0 + batch_size]
            n = len(idxs)
            rgb = np.zeros((batch_size, W, store.rgb_dim), np.float32)
            flow = np.zeros((batch_size, W, store.flow_dim), np.float32)
            tgt = np.zeros((batch_size, W, store.num_classes), np.float32)
            valid = np.zeros((batch_size,), np.float32)
            vids, starts, ends = [], np.zeros(batch_size, np.int64), np.zeros(batch_size, np.int64)
            for j, wi in enumerate(idxs):
                vi, start = self.windows[wi]
                vid = store.vids[vi]
                rgb[j] = store.rgb[vid][start : start + W]
                flow[j] = store.flow[vid][start : start + W]
                tgt[j] = store.target[vid][start : start + W]
                valid[j] = 1.0
                vids.append(vid)
                starts[j], ends[j] = start, start + W
            vids += [""] * (batch_size - n)
            yield Batch(rgb, flow, tgt, valid, vids, starts, ends)


class AnticipationWindowSampler(WindowSampler):
    """Windows with future anticipation targets (THUMOS_ANTICIPATION
    dataset parity, datasets/dataset.py:138-249): train windows stop
    ``anticipation_length`` short of the video end so target[end:end+L]
    exists; each batch carries ant_target (B, L, K)."""

    def __init__(self, store: FeatureStore, window_size: int, stride: int,
                 anticipation_length: int):
        super().__init__(store, window_size, stride)
        self.anticipation_length = anticipation_length

    def resample(self, rng: Optional[np.random.Generator] = None) -> None:
        rng = rng or np.random.default_rng()
        self.windows = []
        L = self.anticipation_length
        for vi, vid in enumerate(self.store.vids):
            T = self.store.length(vid)
            offset = int(rng.integers(0, self.stride))
            # reference: zip(range(seed, T, stride), range(seed+W, T-L, stride))
            for start, end in zip(
                range(offset, T, self.stride),
                range(offset + self.window_size, T - L, self.stride),
            ):
                self.windows.append((vi, start))

    def iter_batches(self, batch_size, shuffle=True, rng=None):
        L = self.anticipation_length
        for batch in super().iter_batches(batch_size, shuffle, rng):
            K = self.store.num_classes
            ant = np.zeros((batch_size, L, K), np.float32)
            for j, vid in enumerate(batch.vids):
                if not vid or batch.valid[j] == 0:
                    continue
                end = int(batch.ends[j])
                ant[j] = self.store.target[vid][end : end + L]
            batch.ant_target = ant  # attached; Batch stays lean for OAD
            yield batch


def pack_eval_batch(
    store: FeatureStore, vids: Optional[List[str]] = None, pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Pack full videos into one padded batch for batched causal streaming.

    Returns (rgb (V,Tmax,Dr), flow (V,Tmax,Df), target (V,Tmax,K),
    lengths (V,), vids). Per-video results beyond ``lengths`` are padding;
    the GRU recurrence is batch-independent, so batched outputs equal the
    reference's batch-1 full-video eval (trainer/eval.py:36-44) exactly.
    """
    vids = vids if vids is not None else list(store.vids)
    lengths = np.array([store.length(v) for v in vids], np.int64)
    Tmax = int(pad_to or lengths.max())
    V = len(vids)
    rgb = np.zeros((V, Tmax, store.rgb_dim), np.float32)
    flow = np.zeros((V, Tmax, store.flow_dim), np.float32)
    tgt = np.zeros((V, Tmax, store.num_classes), np.float32)
    for i, v in enumerate(vids):
        t = lengths[i]
        rgb[i, :t] = store.rgb[v]
        flow[i, :t] = store.flow[v]
        tgt[i, :t] = store.target[v]
    return rgb, flow, tgt, lengths, vids
