"""Assembly101 mistake-label procedures (per-video CSV annotations); the
port's own copy of prego_tpu/data/mistake_labels.py (numpy and csv).

Parity surface: AssemblyLabelDataset + get_OH_data
(step_anticipation/src/data/{assemblyLabelDataset.py:6-57,
dataset_utils.py:9-301}): per-video CSVs with columns
(verb, this, that, label[, remark]) are encoded as one-hot rows
verb(2) ⊕ parts(65) — with the reference's quirk that this==that puts a 2
in the single part slot — plus a 3-way label one-hot
{correct, correction, mistake}; metadata carries (user, toy, idx,
is_correct_procedure).

Split handling: the reference hardcodes correct/mistake filename lists
(dataset_utils.py:302-634). Here the split is derived from the data with
the reference's own predicate (is_correct_procedure: every row labelled
'correct'); explicit filename lists can be passed for exact benchmark
splits.

Also includes the keystep TEXT view ("verb-this-that" strings) that
AssemblyTextDataset exposes (src/data/assembly_text.py:23-120).
"""

from __future__ import annotations

import csv
import os
import os.path as osp
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

VERBS_SORTED = ["attach", "detach"]

PARTS_SORTED = [
    "arm", "arm connector", "back seat", "base", "basket", "battery", "blade",
    "body", "boom", "bucket", "bulldozer arm", "bumper", "cabin", "cabin back",
    "cabin window", "chassis", "clamp", "connector", "container", "crane arm",
    "cylinder", "dashboard", "door", "dump bed", "dumpbed", "engine",
    "engine cover", "excavator arm", "figurine", "fire equipment",
    "fire extinguisher", "grill", "hook", "interior", "jackhammer", "ladder",
    "ladder basket", "lid", "light", "mixer", "mixer stand", "nut",
    "push frame", "rear body", "rear bumper", "rear roof", "rocker panel",
    "roller", "roller arm", "roof", "side ladder", "sound module", "spoiler",
    "step", "strap", "tilter", "track", "transport cabin", "turnplate",
    "turntable base", "turntable top", "water tank", "wheel", "window",
    "windshield",
]

LABELS_SORTED = ["correct", "correction", "mistake"]

SAMPLE_DIM = len(VERBS_SORTED) + len(PARTS_SORTED)  # 67 (frequentist sample_len)


def verb_to_onehot(verb: str) -> np.ndarray:
    oh = np.zeros(len(VERBS_SORTED), np.float32)
    oh[VERBS_SORTED.index(verb)] = 1
    return oh


def parts_to_onehot(this: str, that: str) -> np.ndarray:
    """this == that puts a 2 in the shared slot (dataset_utils.py:100-118)."""
    oh = np.zeros(len(PARTS_SORTED), np.float32)
    if this == that:
        oh[PARTS_SORTED.index(this)] = 2
        return oh
    oh[PARTS_SORTED.index(this)] = 1
    oh[PARTS_SORTED.index(that)] = 1
    return oh


def label_to_onehot(label: str) -> np.ndarray:
    oh = np.zeros(len(LABELS_SORTED), np.float32)
    oh[LABELS_SORTED.index(label)] = 1
    return oh


def extract_user_toy_and_id(name: str) -> Tuple[str, str, str]:
    """(user, toy, idx) from a csv filename (dataset_utils.py:9-26)."""
    name = name.split(".")[0]
    parts = name.split("_")
    user, toy = parts[3].split("-")
    return user, toy, parts[-1]


@dataclass
class Procedure:
    oh_sample: np.ndarray  # (S, 67)
    oh_label: np.ndarray  # (S, 3)
    keysteps: List[str]  # "verb-this-that" text view
    metadata: Tuple[str, str, str, int]  # (user, toy, idx, is_correct)


def _read_rows(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_procedure(path: str) -> Procedure:
    rows = _read_rows(path)
    samples, labels, keysteps = [], [], []
    for row in rows:
        samples.append(
            np.concatenate([verb_to_onehot(row["verb"]), parts_to_onehot(row["this"], row["that"])])
        )
        labels.append(label_to_onehot(row["label"]))
        # assembly_text.py:49-55 parity: spaces removed inside each field,
        # fields joined with "-"
        keysteps.append(
            "-".join(row[k].replace(" ", "") for k in ("verb", "this", "that")).strip()
        )
    is_correct = int(all(r["label"] == "correct" for r in rows))
    return Procedure(
        oh_sample=np.stack(samples) if samples else np.zeros((0, SAMPLE_DIM), np.float32),
        oh_label=np.stack(labels) if labels else np.zeros((0, 3), np.float32),
        keysteps=keysteps,
        metadata=(*extract_user_toy_and_id(osp.basename(path)), is_correct),
    )


class MistakeLabelDataset:
    """All per-video procedures of a split, host-resident."""

    def __init__(
        self,
        csv_dir: str,
        split: str = "all",
        filenames: Optional[Sequence[str]] = None,
    ):
        assert split in ("all", "correct", "mistake"), split
        if filenames is None:
            filenames = sorted(f for f in os.listdir(csv_dir) if f.endswith(".csv"))
        self.procedures: List[Procedure] = []
        for fn in filenames:
            proc = load_procedure(osp.join(csv_dir, fn))
            is_correct = proc.metadata[3]
            if split == "correct" and not is_correct:
                continue
            if split == "mistake" and is_correct:
                continue
            self.procedures.append(proc)

    def __len__(self) -> int:
        return len(self.procedures)

    def __getitem__(self, idx: int) -> Dict:
        p = self.procedures[idx]
        return {
            "oh_sample": p.oh_sample,
            "oh_label": p.oh_label,
            "keysteps": p.keysteps,
            "metadata": p.metadata,
        }

    def keystep_texts(self) -> List[List[str]]:
        """AssemblyTextDataset view: per-video keystep token strings."""
        return [p.keysteps for p in self.procedures]
