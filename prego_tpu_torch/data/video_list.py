"""Dataset split / class-name metadata (the port's own copy of
prego_tpu/data/video_list.py, no dependencies).

Parity surface: step_recognition/data_info/video_list.json — a JSON keyed by
dataset name with ``class_index`` (class names, index 0 = background),
``train_session_set`` and ``test_session_set`` video-name lists
(reference consumption: datasets/dataset.py:36-39, trainer/eval.py:25-28).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List


@dataclass(frozen=True)
class DatasetInfo:
    name: str
    class_index: List[str]
    train_session_set: List[str]
    test_session_set: List[str]

    @property
    def num_classes(self) -> int:
        return len(self.class_index)


def load_video_list(path: str) -> Dict[str, DatasetInfo]:
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for name, entry in raw.items():
        out[name] = DatasetInfo(
            name=name,
            class_index=list(entry["class_index"]),
            train_session_set=list(entry["train_session_set"]),
            test_session_set=list(entry["test_session_set"]),
        )
    return out


def load_dataset_info(path: str, data_name: str) -> DatasetInfo:
    # The reference splits on '_' for *_ANTICIPATION variants (eval.py:26).
    base = data_name.split("_")[0] if data_name.endswith("_ANTICIPATION") else data_name
    return load_video_list(path)[base]
