"""Per-video TSN feature store (the port's own copy of
prego_tpu/data/features.py, numpy only).

Parity surface: THUMOSDataset._load_features
(step_recognition/datasets/dataset.py:45-94). Behaviors kept as spec
(see SURVEY.md §7 quirks catalog):

  * layout: <root>/<annotation_type>/<vid>.npy  (T, num_classes) one-hot,
            <root>/<rgb_type>/<vid>.npy         (T, D_rgb),
            <root>/<flow_type>/...               (T, D_flow)
  * for flow_type == 'flow_anet_resnet50' the reference loads
    <root>/rgb_as_flow/<rgb_type>/<vid>.npy then REPLACES it with zeros
    (dataset.py:63-69) — the shipped checkpoints were trained on
    rgb + zero-flow, so this is part of the input contract. We record
    ``flow_is_zero`` so the model can skip the dead half of the input
    matmul instead of multiplying zeros.
  * other flow types load
    <root>/<flow_type>/assembly_optical_flow_BNInception/<vid>/assembling.npy
    (dataset.py:70-75).
  * train mode prepends window_size-1 zero rows to features and targets
    (dataset.py:53-55,77-82) so the first real frame can be a window end.
  * videos whose features fail to load are dropped (dataset.py:87-93);
    the known-corrupt Assembly101 video is always dropped (dataset.py:100-107).

Storage is float32 host numpy; windows are gathered by slicing and shipped
to the device per batch (full-video eval streams chunks through the GRU
kernel instead).
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

FEATURE_SIZES = {
    "rgb_anet_resnet50": 2048,
    "flow_anet_resnet50": 2048,
    "rgb_kinetics_bninception": 1024,
    "flow_kinetics_bninception": 1024,
    "rgb_kinetics_resnet50": 2048,
    "flow_kinetics_resnet50": 2048,
    "flow_nv_kinetics_bninception": 1024,
    "rgb_kinetics_i3d": 2048,
    "flow_kinetics_i3d": 2048,
}

# dataset.py:100-107 — hard-removed corrupt Assembly101 video.
CORRUPT_VIDEOS = frozenset(
    ["nusar-2021_action_both_9056-b08a_9056_user_id_2021-02-22_141934"]
)

# The flow branch whose features are structurally zeroed (dataset.py:63-69).
ZEROED_FLOW_TYPE = "flow_anet_resnet50"


@dataclass
class FeatureStore:
    """All videos of one split resident in host RAM, reference-compatible."""

    vids: List[str]
    rgb: Dict[str, np.ndarray]
    flow: Dict[str, np.ndarray]
    target: Dict[str, np.ndarray]
    flow_is_zero: bool
    removed: int = 0
    rgb_dim: int = 0
    flow_dim: int = 0
    num_classes: int = 0

    def length(self, vid: str) -> int:
        return self.target[vid].shape[0]

    @property
    def max_length(self) -> int:
        return max(self.target[v].shape[0] for v in self.vids)


def load_feature_store(
    root_path: str,
    vids: List[str],
    rgb_type: str,
    flow_type: str,
    annotation_type: str,
    num_classes: int,
    training: bool,
    window_size: int,
    logger=None,
) -> FeatureStore:
    vids = [v for v in vids if v not in CORRUPT_VIDEOS]
    rgb_dim = FEATURE_SIZES[rgb_type]
    flow_dim = FEATURE_SIZES[flow_type]
    flow_is_zero = flow_type == ZEROED_FLOW_TYPE

    pad = window_size - 1 if training else 0
    rgb_d: Dict[str, np.ndarray] = {}
    flow_d: Dict[str, np.ndarray] = {}
    tgt_d: Dict[str, np.ndarray] = {}
    kept: List[str] = []
    removed = 0
    for vid in vids:
        try:
            target = np.load(osp.join(root_path, annotation_type, vid + ".npy"))
            rgb = np.load(osp.join(root_path, rgb_type, vid + ".npy"))
            if flow_is_zero:
                # Shape probed from rgb_as_flow if present, else mirrors rgb —
                # content is zeros either way (dataset.py:63-69).
                shape_src = osp.join(root_path, "rgb_as_flow", rgb_type, vid + ".npy")
                if osp.exists(shape_src):
                    flow_shape = _npy_shape(shape_src)
                else:
                    flow_shape = (rgb.shape[0], flow_dim)
                flow = np.zeros(flow_shape, dtype=np.float32)
            else:
                flow = np.load(
                    osp.join(
                        root_path,
                        flow_type,
                        "assembly_optical_flow_BNInception",
                        vid,
                        "assembling.npy",
                    )
                )
        except Exception as e:  # drop videos with missing features
            removed += 1
            if logger is not None:
                logger.info(f"dropped video {vid}: {e}")
            continue
        target = np.asarray(target, dtype=np.float32)
        rgb = np.asarray(rgb, dtype=np.float32)
        flow = np.asarray(flow, dtype=np.float32)
        if pad:
            target = np.concatenate(
                [np.zeros((pad, target.shape[1]), np.float32), target], axis=0
            )
            rgb = np.concatenate([np.zeros((pad, rgb.shape[1]), np.float32), rgb], axis=0)
            flow = np.concatenate(
                [np.zeros((pad, flow.shape[1]), np.float32), flow], axis=0
            )
        tgt_d[vid] = target
        rgb_d[vid] = rgb
        flow_d[vid] = flow
        kept.append(vid)

    return FeatureStore(
        vids=kept,
        rgb=rgb_d,
        flow=flow_d,
        target=tgt_d,
        flow_is_zero=flow_is_zero,
        removed=removed,
        rgb_dim=rgb_dim,
        flow_dim=flow_dim,
        num_classes=num_classes,
    )


def _npy_shape(path: str) -> Tuple[int, ...]:
    """Read an .npy header without loading the data."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        shape, _, _ = np.lib.format._read_array_header(f, version)
    return shape
