"""Native-backed recognition data (port of prego_tpu/data/native_loader.py).

Same semantics as ``load_feature_store`` + ``WindowSampler`` (the training
zero prefix, dataset.py:53-55, the zeroed-flow quirk, dataset.py:63-69,
and dropped missing videos) over the C++ mmap feature store
(``prego_tpu_torch/native``): nothing is loaded eagerly, and training
batches are assembled by the native thread pool straight from the OS page
cache. The zero prefix is virtual: window starts are shifted by
-(window_size-1) and rows outside a file are zero-filled by the gather.

The handover to the card. Given a CUDA device, ``NativeWindowSampler``
gathers into a ring of pinned host buffers (RING_DEPTH = 3 sets of rgb,
flow, target and valid tensors), so the train loop can copy a batch
with ``non_blocking=True`` while the card still runs the previous step. The
batch after next is gathered while the current one is consumed. A slot is
written again only after the loop has marked its batch copied
(``Batch.on_copied``, which records a CUDA event on the current stream
after the copy) and that event has completed: otherwise the pool could
overwrite a batch whose copy is still in flight. A slot whose batch was
never marked copied is still its consumer's, and gets fresh buffers. On
the CPU the same ring runs over pageable tensors, with a host stand-in
for the event. Pinning that fails raises.
"""

from __future__ import annotations

import os.path as osp
from typing import Callable, Iterator, List, Optional, Union

import numpy as np
import torch

from prego_tpu_torch.data.features import CORRUPT_VIDEOS, FEATURE_SIZES, ZEROED_FLOW_TYPE
from prego_tpu_torch.data.windowing import Batch
from prego_tpu_torch.native import NativeFeatureStore

PAD_START = -(10 ** 9)  # the start of a padding row of the trailing batch: all zeros
# one batch consumed, one gathering, one whose copy may still be in flight
RING_DEPTH = 3


class _LazyVideo:
    """Sliceable view of one video's rows in a native store (virtual zero
    prefix applied); materializes only the requested range."""

    def __init__(self, fs: NativeFeatureStore, idx: int, pad: int, length: int,
                 zero_dim: Optional[int] = None):
        self._fs = fs
        self._idx = idx
        self._pad = pad
        self._len = length
        self._zero_dim = zero_dim  # a structurally zero stream (the flow quirk)

    @property
    def shape(self):
        dim = self._zero_dim if self._zero_dim is not None else self._fs.dims(self._idx)[1]
        return (self._len, dim)

    def __len__(self):
        return self._len

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._len)
            if step != 1:
                raise ValueError("only contiguous slices supported")
            if self._zero_dim is not None:
                return np.zeros((max(stop - start, 0), self._zero_dim), np.float32)
            return self._fs.read_rows(self._idx, start - self._pad, max(stop - start, 0))
        raise TypeError("index videos with contiguous slices")

    def __array__(self, dtype=None, copy=None):
        out = self[0 : self._len]
        return out.astype(dtype) if dtype is not None else out


class _LazyColumn:
    def __init__(self, data: "NativeRecognitionData", which: str):
        self._d = data
        self._which = which

    def __getitem__(self, vid: str) -> _LazyVideo:
        d = self._d
        idx = int(d._indices[d._position[vid]])
        if self._which == "rgb":
            return _LazyVideo(d._rgb, idx, d.pad, d.length(vid))
        if self._which == "target":
            return _LazyVideo(d._tgt, idx, d.pad, d.length(vid))
        if d._flow is None:  # the zeroed flow quirk: zeros on demand
            return _LazyVideo(d._rgb, idx, d.pad, d.length(vid), zero_dim=d.flow_dim)
        return _LazyVideo(d._flow, idx, d.pad, d.length(vid))


class NativeRecognitionData:
    """Lazy rgb / flow / target stores of one split. Exposes the
    FeatureStore surface (vids, length, flow_is_zero, dims, and rgb / flow
    / target dict-style views), so the samplers and the lazy evaluator run
    off the mmap directly."""

    def __init__(self, root_path: str, vids: List[str], rgb_type: str, flow_type: str,
                 annotation_type: str, num_classes: int, training: bool, window_size: int,
                 n_threads: int = 4, logger=None):
        vids = [v for v in vids if v not in CORRUPT_VIDEOS]
        self.training = training
        self.window_size = window_size
        self.pad = window_size - 1 if training else 0
        self.rgb_dim = FEATURE_SIZES[rgb_type]
        self.flow_dim = FEATURE_SIZES[flow_type]
        self.num_classes = num_classes
        self.flow_is_zero = flow_type == ZEROED_FLOW_TYPE

        self._rgb = NativeFeatureStore([osp.join(root_path, rgb_type, v + ".npy") for v in vids],
                                       n_threads)
        self._tgt = NativeFeatureStore(
            [osp.join(root_path, annotation_type, v + ".npy") for v in vids], n_threads)
        self._flow = None if self.flow_is_zero else NativeFeatureStore(
            [osp.join(root_path, flow_type, "assembly_optical_flow_BNInception", v,
                      "assembling.npy") for v in vids], n_threads)

        ok = self._rgb.ok & self._tgt.ok
        if self._flow is not None:
            ok = ok & self._flow.ok
        self.removed = int((~ok).sum())
        if logger is not None:
            for v, good in zip(vids, ok):
                if not good:
                    logger.info(f"dropped video {v} (missing features)")
        # the native stores keep every slot; the bad ones are skipped here
        self.vids = [v for v, good in zip(vids, ok) if good]
        self._indices = np.flatnonzero(ok).astype(np.int32)
        self._position = {v: i for i, v in enumerate(self.vids)}
        self._lengths = {v: self._tgt.dims(int(i))[0] + self.pad
                         for v, i in zip(self.vids, self._indices)}
        self.rgb = _LazyColumn(self, "rgb")
        self.flow = _LazyColumn(self, "flow")
        self.target = _LazyColumn(self, "target")

    def length(self, vid: str) -> int:
        """Video length including the virtual training prefix."""
        return self._lengths[vid]

    def gather_async(self, vid_order: np.ndarray, starts: np.ndarray, window: int,
                     rgb: torch.Tensor, flow: Optional[torch.Tensor], target: torch.Tensor):
        """Start gathering the windows (``vid_order`` indexes ``vids``,
        ``starts`` are virtual) into the given buffers on the native thread
        pool; returns the pending gathers (flow's None where the flow
        stream is zero)."""
        native_idx = self._indices[vid_order]
        real = starts - self.pad
        return (self._rgb.gather_windows_async(native_idx, real, window, self.rgb_dim, rgb),
                None if self._flow is None else
                self._flow.gather_windows_async(native_idx, real, window, self.flow_dim, flow),
                self._tgt.gather_windows_async(native_idx, real, window, self.num_classes,
                                               target))


class HostEvent:
    """The CPU's stand-in for a CUDA event: a batch on the CPU is copied
    (or read in place) by the time the loop marks it, so a recorded event
    has completed."""

    def record(self, stream=None) -> None:
        pass

    def synchronize(self) -> None:
        pass


class BatchRing:
    """``depth`` slots of host buffers for (B, W, D) batches, each with the
    event of its last copy. ``acquire(i)`` hands out slot ``i % depth``
    for writing: it first waits for the event of the copy that read the
    slot last, or, where that batch was never marked copied, replaces the
    slot's buffers (its consumer may still hold them)."""

    def __init__(self, depth: int, shapes: dict, pin: bool,
                 make_event: Callable[[], object] = HostEvent):
        if depth < 3:
            raise ValueError(f"ring depth {depth}: at least 3 (one consumed, one gathering, "
                             "one whose copy may be in flight)")
        self.depth = depth
        self.shapes = shapes
        self.pin = pin
        self.make_event = make_event
        self.slots = [self._fresh() for _ in range(depth)]
        self.released = [True] * depth  # a fresh slot is free
        self.events = [None] * depth
        self.replaced = 0  # slots handed out fresh because their batch was never marked

    def _fresh(self) -> dict:
        # pin_memory=True raises where the memory cannot be pinned
        return {k: None if s is None else torch.empty(s, dtype=torch.float32, pin_memory=self.pin)
                for k, s in self.shapes.items()}

    def acquire(self, i: int) -> dict:
        k = i % self.depth
        if not self.released[k]:
            self.slots[k] = self._fresh()
            self.replaced += 1
        elif self.events[k] is not None:
            self.events[k].synchronize()  # the copy that read this slot has ended
        self.released[k], self.events[k] = False, None
        return self.slots[k]

    def mark_copied(self, i: int, stream=None) -> None:
        """The batch in slot ``i % depth`` has been copied (enqueued on
        ``stream`` for a CUDA copy): record the slot's event."""
        k = i % self.depth
        event = self.make_event()
        event.record(stream)
        self.events[k], self.released[k] = event, True


class NativeWindowSampler:
    """Reference windowing semantics over the native store (dataset.py:113-119:
    a random offset a video each epoch, strided windows), batches gathered
    by the native pool into a ring of host buffers, pinned for a CUDA
    ``device``. ``store`` is named as ``WindowSampler``'s (the JAX
    package's native sampler calls it ``data``); ``make_event`` makes the
    event recorded after a batch's copy (a test may pass a stand-in)."""

    def __init__(self, store: NativeRecognitionData, window_size: int, stride: int,
                 device: Union[str, torch.device, None] = None,
                 make_event: Optional[Callable[[], object]] = None):
        self.store = store
        self.window_size = window_size
        self.stride = stride
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        cuda = self.device.type == "cuda"
        self.make_event = make_event or (torch.cuda.Event if cuda else HostEvent)
        self.pin = cuda
        self.windows: List = []
        self.ring: Optional[BatchRing] = None
        self._zero_flow: Optional[torch.Tensor] = None

    def resample(self, rng: Optional[np.random.Generator] = None) -> None:
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

    def _ring(self, batch_size: int) -> BatchRing:
        W, d = self.window_size, self.store
        shapes = {"rgb": (batch_size, W, d.rgb_dim),
                  "flow": None if d.flow_is_zero else (batch_size, W, d.flow_dim),
                  "target": (batch_size, W, d.num_classes), "valid": (batch_size,)}
        if self.ring is None or self.ring.shapes != shapes:
            self.ring = BatchRing(RING_DEPTH, shapes, self.pin, self.make_event)
            # the zero flow stream: one tensor, never written
            self._zero_flow = (torch.zeros((batch_size, W, d.flow_dim), dtype=torch.float32)
                               if d.flow_is_zero else None)
        return self.ring

    def _mark(self, ring: BatchRing, i: int) -> Callable[[], None]:
        stream = (lambda: torch.cuda.current_stream(self.device)) if self.pin else (lambda: None)
        return lambda: ring.mark_copied(i, stream())

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     rng: Optional[np.random.Generator] = None) -> Iterator[Batch]:
        """Batches in the numpy sampler's order and layout, as float32 CPU
        tensors from the ring (rgb, flow, target and valid). Batch i+1 is
        gathered by the native pool while batch i is consumed. A batch's
        tensors are the ring's: call ``batch.on_copied()`` once they are
        copied (or read), and clone what must outlive the next batches."""
        if not self.windows:
            self.resample(rng)
        order = np.arange(len(self.windows))
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        W = self.window_size
        win = np.asarray(self.windows, np.int64).reshape(-1, 2)
        metas = []
        for b0 in range(0, len(order), batch_size):
            idxs = order[b0 : b0 + batch_size]
            n = len(idxs)
            vid_order, starts = win[idxs, 0], win[idxs, 1]
            if n < batch_size:  # pad the trailing batch (masked out of the loss)
                vid_order = np.concatenate([vid_order, np.zeros(batch_size - n, np.int64)])
                starts = np.concatenate([starts, np.full(batch_size - n, PAD_START, np.int64)])
            metas.append((vid_order, starts, n))
        if not metas:
            return
        ring = self._ring(batch_size)

        def start(i):
            bufs = ring.acquire(i)
            vid_order, starts, _ = metas[i]
            return bufs, self.store.gather_async(vid_order, starts, W, bufs["rgb"], bufs["flow"],
                                                bufs["target"])

        pending = start(0)
        for i, (vid_order, starts, n) in enumerate(metas):
            bufs, gathers = pending
            for g in gathers:
                if g is not None:
                    g.wait()
            pending = start(i + 1) if i + 1 < len(metas) else None
            valid = bufs["valid"]
            valid.zero_()
            valid[:n] = 1.0
            vids = [self.store.vids[int(v)] for v in vid_order[:n]] + [""] * (batch_size - n)
            flow = bufs["flow"] if bufs["flow"] is not None else self._zero_flow
            yield Batch(bufs["rgb"], flow, bufs["target"], valid, vids,
                        starts.astype(np.int64), (starts + W).astype(np.int64),
                        on_copied=self._mark(ring, i))
