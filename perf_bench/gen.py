"""The general traffic generator: every traffic mix is a data file of
parameters that the functions here read.

The sizes of a mix (video step counts, context lengths, video frame
counts) are fixed by the file alone, in an order fixed by the file; the
seed draws the content (step labels, examples, features, segment
boundaries). Every seed then does the same work in the same order, and
runs with different seeds spread no more than runs of one seed.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

INIT, INPUT, OUTPUT = "Sequence type:", "Input Sequence:", "Next Symbol:"  # the default style


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), salt])


def fixed_sizes(lo: int, hi: int, count: int, salt: int) -> List[int]:
    """``count`` sizes spread evenly over [lo, hi], in an order that depends
    on ``salt`` alone, never on the seed."""
    sizes = np.round(np.linspace(lo, hi, count)).astype(int)
    order = np.random.default_rng(salt).permutation(count)
    return [int(s) for s in sizes[order]]


def _label(rng: np.random.Generator, lo: int, hi: int) -> int:
    return int(rng.integers(lo, hi + 1))


def example_block(toy: str, symbols: List[int], answer: int) -> str:
    """One in-context example in the prompt's own format."""
    hist = ", ".join(["-1"] + [str(s) for s in symbols])
    return f"{INIT} {toy}\n{INPUT}\n {hist}\n{OUTPUT}\n {answer}\n"


def make_context(head: str, toy: str, length: int, labels: Tuple[int, int],
                 rng: np.random.Generator) -> str:
    """The instruction head and in-context examples of one toy, exactly
    ``length`` bytes (the byte tokenizer's tokens) long where ``length``
    is not below the head and one example. Labels are two-digit, so the
    length depends on ``length`` alone."""
    lo, hi = labels
    text = head
    empty = len(example_block(toy, [], 10))  # a symbol adds ", NN": 4 bytes
    while True:
        room = length - len(text)
        if room >= empty + 4 * 8 + empty + 4:
            n = 8
        elif room >= empty + 4:
            n = (room - empty) // 4  # the last example: under 4 bytes left
        else:
            return text + "\n" * max(room, 0)
        text += example_block(toy, [_label(rng, lo, hi) for _ in range(n)], _label(rng, lo, hi))


@dataclass
class Collection:
    """Videos of recognized steps, each of one toy, and each toy's context."""

    toys: List[str]
    contexts: List[str]
    videos: List[Tuple[int, List[int]]]  # (toy index, step labels)


def make_contexts(t: Dict, seed: int) -> Tuple[List[str], List[str]]:
    """``toys`` toy names and their contexts, of ``context_tokens`` bytes
    spread over the toys; only the instruction head is shared."""
    n_toys = int(t["toys"])
    toys = [f"toy{i}" for i in range(n_toys)]
    lo, hi = t["context_tokens"]
    lengths = np.round(np.linspace(lo, hi, n_toys)).astype(int)
    ctx_rng = _rng(seed, 1)
    contexts = [make_context(t["head"], toys[i], int(lengths[i]), tuple(t["labels"]), ctx_rng)
                for i in range(n_toys)]
    return toys, contexts


def make_collection(t: Dict, seed: int) -> Collection:
    """The offline collection of a mix: the toys' contexts
    (``make_contexts``), ``videos`` videos with ``steps`` steps spread over
    them, each video's toy fixed by the file."""
    n_toys = int(t["toys"])
    labels = tuple(t["labels"])
    toys, contexts = make_contexts(t, seed)
    steps = fixed_sizes(t["steps"][0], t["steps"][1], int(t["videos"]), salt=2)
    toy_of = np.random.default_rng(3).integers(0, n_toys, size=len(steps))
    rng = _rng(seed, 4)
    videos = [(int(toy_of[i]), [_label(rng, *labels) for _ in range(n)])
              for i, n in enumerate(steps)]
    return Collection(toys=toys, contexts=contexts, videos=videos)


def segments(total: int, lo: int, hi: int, classes: Tuple[int, int],
             rng: np.random.Generator) -> np.ndarray:
    """Per-frame step labels of a video of ``total`` frames cut into
    segments of ``lo`` to ``hi`` frames, consecutive labels distinct."""
    out = np.empty(total, np.int64)
    t, prev = 0, -1
    while t < total:
        n = int(rng.integers(lo, hi + 1))
        c = prev
        while c == prev:
            c = int(rng.integers(classes[0], classes[1] + 1))
        out[t:t + n] = c
        t, prev = t + n, c
    return out


def cut(total: int, lo: int, hi: int, rng: np.random.Generator) -> List[int]:
    """The first frames of segments of ``lo`` to ``hi`` frames over ``total``."""
    out, t = [], 0
    while t < total:
        out.append(t)
        t += int(rng.integers(lo, hi + 1))
    return out


def label_segments(total: int, starts: List[int], num_classes: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Per-frame labels: a step (1 to num_classes - 1) a segment, consecutive
    steps distinct."""
    out = np.empty(total, np.int64)
    prev = -1
    for i, s in enumerate(starts):
        c = prev
        while c == prev:
            c = _label(rng, 1, num_classes - 1)
        out[s:starts[i + 1] if i + 1 < len(starts) else total] = c
        prev = c
    return out


def frame_features(labels: np.ndarray, dim: int, prototypes: np.ndarray, noise: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Features of a video: each frame its step's prototype plus noise."""
    x = rng.standard_normal((len(labels), dim), dtype=np.float32) * np.float32(noise)
    x += prototypes[labels]
    return x


def _save(path: str, array: np.ndarray) -> None:
    """np.save, on disk before it returns: the write-back happens here, in
    set-up, and not later beside the window."""
    with open(path, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())


def write_feature_videos(t: Dict, seed: int, root: str, rgb_type: str, num_classes: int,
                         rgb_dim: int) -> Dict[str, int]:
    """Writes an Assembly101-O-shaped split under ``root``: per video
    ``<rgb_type>/<vid>.npy`` (T, rgb_dim) f32 and
    ``target_perframe/<vid>.npy`` (T, num_classes) one-hot, and
    ``video_list.json``. Frame counts are fixed by the file; labels,
    segments and features come from the seed. Returns {vid: frames}."""
    frames = fixed_sizes(t["frames"][0], t["frames"][1], int(t["videos"]), salt=5)
    rng = _rng(seed, 6)
    protos = rng.standard_normal((num_classes, rgb_dim), dtype=np.float32)
    os.makedirs(os.path.join(root, rgb_type), exist_ok=True)
    os.makedirs(os.path.join(root, "target_perframe"), exist_ok=True)
    out = {}
    seg_lo, seg_hi = t["segment_frames"]
    for i, n in enumerate(frames):
        vid = f"video{i:03d}"
        lab = segments(n, seg_lo, seg_hi, (1, num_classes - 1), rng)
        _save(os.path.join(root, rgb_type, vid + ".npy"),
              frame_features(lab, rgb_dim, protos, float(t["noise"]), rng))
        _save(os.path.join(root, "target_perframe", vid + ".npy"),
              np.eye(num_classes, dtype=np.float32)[lab])
        out[vid] = n
    vids = sorted(out)
    info = {"class_index": [f"step{c}" for c in range(num_classes)],
            "train_session_set": vids, "test_session_set": vids[:1]}
    with open(os.path.join(root, "video_list.json"), "w") as f:
        json.dump({t["data_name"]: info}, f)
    return out


@dataclass
class Streams:
    """Camera streams cut into blocks: ``features[k]`` is block k, (frames,
    streams, dim) f32; ``starts[k]`` the streams whose next video starts
    with block k; ``toy_of[b]`` stream b's toy."""

    features: List[np.ndarray]
    starts: List[List[int]]
    toy_of: List[int]


def make_streams(t: Dict, seed: int, num_classes: int, dim: int) -> Streams:
    """``blocks`` blocks of ``block_frames`` frames for ``streams`` streams.
    Each stream plays videos of ``video_blocks`` blocks, cut into step
    segments of ``segment_frames`` frames: the lengths and boundaries are
    fixed by the file (a stream's sequence offset by its index), so that
    every seed raises about as many checks in the same blocks. The seed
    draws the steps' labels and the features: a frame is its step's
    prototype plus noise, so that the votes change between segments."""
    B, N, K = int(t["streams"]), int(t["block_frames"]), int(t["blocks"])
    lengths = fixed_sizes(t["video_blocks"][0], t["video_blocks"][1], 16, salt=9)
    cuts = np.random.default_rng(10)  # segment boundaries: the file's, not the seed's
    rng = _rng(seed, 8)
    protos = rng.standard_normal((num_classes, dim), dtype=np.float32)
    labels = np.empty((K * N, B), np.int64)
    starts: List[List[int]] = [[] for _ in range(K)]
    for b in range(B):
        k, v = 0, b
        while k < K:
            n = lengths[v % len(lengths)]
            starts[k].append(b)
            seg = label_segments(n * N, cut(n * N, *t["segment_frames"], cuts),
                                 num_classes, rng)
            take = min(n, K - k) * N
            labels[k * N:k * N + take, b] = seg[:take]
            k, v = k + n, v + 1
    feats = []
    for k in range(K):
        lab = labels[k * N:(k + 1) * N]
        x = rng.standard_normal((N, B, dim), dtype=np.float32) * np.float32(t["noise"])
        x += protos[lab]
        feats.append(x)
    toy_of = [b % int(t["toys"]) for b in range(B)]
    return Streams(features=feats, starts=starts, toy_of=toy_of)
