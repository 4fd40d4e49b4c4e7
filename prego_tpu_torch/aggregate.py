"""TI-PREGO prediction aggregation, vectorized (the port's own copy of
prego_tpu/aggregate.py, numpy only).

Parity surface: utils/aggregate.py:7-109 —
  * per video, majority-vote the per-frame predicted class in fixed
    200-frame windows (last window may be shorter); ties resolve to the
    LOWEST class id (np.bincount -> np.argmax picks the first maximum,
    aggregate.py:69-70);
  * record change indices of the smoothed prediction and of the RAW
    ground truth (each list ends with len(arr), aggregate.py:26-43);
  * collapse consecutive duplicates in both (aggregate.py:7-23);
  * emit {pred, gt, changes_pred, changes_gt} JSON.

The reference loops per frame in python; here the vote is one one-hot
scatter + argmax over (num_windows, K) and change-points are a single
vectorized comparison. Output is element-for-element identical.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np

WINDOW_SIZE = 200  # aggregate.py:55


def eliminate_consecutive_duplicates(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.size == 0:
        return arr
    keep = np.r_[True, arr[1:] != arr[:-1]]
    return arr[keep]


def find_changes(arr: np.ndarray) -> List[int]:
    arr = np.asarray(arr)
    changes = (np.flatnonzero(arr[1:] != arr[:-1]) + 1).tolist()
    changes.append(len(arr))
    return changes


def window_majority_vote(predictions: np.ndarray, window_size: int = WINDOW_SIZE) -> np.ndarray:
    """Per fixed window, replace every frame with the window's modal class."""
    predictions = np.asarray(predictions, dtype=np.int64)
    n = len(predictions)
    if n == 0:
        return predictions
    num_windows = -(-n // window_size)
    k = int(predictions.max()) + 1
    win_idx = np.arange(n) // window_size
    counts = np.zeros((num_windows, k), dtype=np.int64)
    np.add.at(counts, (win_idx, predictions), 1)
    # argmax picks the first (lowest-id) maximum — matches np.bincount+argmax
    winners = np.argmax(counts, axis=1)
    return winners[win_idx]


def aggregate_video(pred: List[int], gt: List[int], window_size: int = WINDOW_SIZE) -> Dict[str, Any]:
    pred = np.asarray(pred, dtype=np.int64)
    gt = np.asarray(gt, dtype=np.int64)
    smoothed = window_majority_vote(pred, window_size)
    return {
        "pred": eliminate_consecutive_duplicates(smoothed).tolist(),
        "gt": eliminate_consecutive_duplicates(gt).tolist(),
        "changes_pred": find_changes(smoothed),
        "changes_gt": find_changes(gt),
    }


def aggregate(data: Dict[str, Dict[str, Any]], output_path: str | None = None) -> Dict[str, Any]:
    aggregated = {
        key: aggregate_video(value["pred"], value["gt"]) for key, value in data.items()
    }
    if output_path is not None:
        with open(output_path, "w") as fp:
            json.dump(aggregated, fp)
    return aggregated


def main(argv: List[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="Aggregate per-frame predictions into step sequences."
    )
    parser.add_argument("input_path", type=str)
    parser.add_argument("output_path", type=str)
    args = parser.parse_args(argv)
    with open(args.input_path) as fp:
        data = json.load(fp)
    aggregate(data, args.output_path)


if __name__ == "__main__":
    main()
