"""Per-frame average-precision metrics (the port's own copy of
prego_tpu/metrics/perframe.py, numpy only).

Attribution: the AP/cAP/per-stage definitions below follow the reference's
LSTR-derived evaluation code structure-for-structure — they are the output
contract of the benchmark, treated as spec, not original algorithm design.

Parity surface: step_recognition/utils/metrics.py:10-130 (itself from LSTR):
  * perframe_average_precision — per-class AP over frames, background
    class 0 ignored, classes with no positive frames skipped, mean over
    the rest (metrics.py:25-62);
  * calibrated AP (cAP) for TVSeries (metrics.py:10-22);
  * per-stage AP over action-progress deciles (metrics.py:64-130).

AP here is computed sklearn-compatibly (step-wise interpolation of the
precision-recall curve as in sklearn.metrics.average_precision_score);
sklearn is used when importable, with an identical numpy fallback.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional

import numpy as np

try:  # sklearn is available in the target image; fallback keeps tests hermetic
    from sklearn.metrics import average_precision_score as _sk_ap
except Exception:  # pragma: no cover
    _sk_ap = None


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    if _sk_ap is not None:
        return float(_sk_ap(y_true, y_score))
    return _average_precision_np(y_true, y_score)


def _average_precision_np(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """sklearn-equivalent AP: sum over thresholds of (R_n - R_{n-1}) * P_n."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    desc = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[desc]
    y_score = y_score[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    # prepend the (recall=0) point
    precision = np.r_[precision]
    recall = np.r_[recall]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def calibrated_average_precision_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """cAP (metrics.py:10-22): precision weighted by the neg/pos ratio."""
    y_true_sorted = y_true[np.argsort(-y_score)]
    tp = y_true_sorted.astype(float)
    fp = np.abs(y_true_sorted.astype(float) - 1)
    tps = np.cumsum(tp)
    fps = np.cumsum(fp)
    ratio = np.sum(tp == 0) / np.sum(tp)
    eps = np.finfo(float).eps
    cprec = tps / (tps + fps / (ratio + eps) + eps)
    return float(np.sum(cprec[tp == 1]) / np.sum(tp))


def perframe_average_precision(
    prediction,
    ground_truth,
    class_names: List[str],
    postprocessing: Optional[Callable] = None,
    metrics: str = "AP",
) -> OrderedDict:
    result = OrderedDict()
    ground_truth = np.asarray(ground_truth)
    prediction = np.asarray(prediction)

    if postprocessing is not None:
        ground_truth, prediction = postprocessing(ground_truth, prediction)

    if metrics == "AP":
        compute_score = average_precision
    elif metrics == "cAP":
        compute_score = calibrated_average_precision_score
    else:
        raise RuntimeError(f"Unknown metrics: {metrics}")

    ignore_index = {0}  # background
    result["per_class_AP"] = OrderedDict()
    result["num"] = OrderedDict()
    for idx, class_name in enumerate(class_names):
        if idx in ignore_index:
            continue
        if np.any(ground_truth[:, idx]):
            ap = compute_score(ground_truth[:, idx], prediction[:, idx])
            result["per_class_AP"][class_name] = ap
            result["num"][class_name] = (
                f"[true: {int(np.sum(ground_truth[:, idx]))}, "
                f"pred:{int(np.sum(prediction[:, idx]))}, AP:{ap * 100:.1f}]"
            )
    result["mean_AP"] = (
        float(np.mean(list(result["per_class_AP"].values())))
        if result["per_class_AP"]
        else 0.0
    )
    return result


def get_stage_pred_scores(gt_targets, pred_scores, perc_s, perc_e):
    """Slice frames by action-progress percentile (metrics.py:64-88)."""
    starts, ends = [], []
    stage_gt, stage_pred = [], []
    for i in range(len(gt_targets)):
        if gt_targets[i] == 0:
            stage_gt.append(gt_targets[i])
            stage_pred.append(pred_scores[i])
        else:
            if i == 0 or gt_targets[i - 1] == 0:
                starts.append(i)
            if i == len(gt_targets) - 1 or gt_targets[i + 1] == 0:
                ends.append(i)
    if len(starts) != len(ends):
        raise ValueError("starts and ends cannot pair!")
    lens = [ends[i] - starts[i] for i in range(len(starts))]
    ss = [starts[i] + int(lens[i] * perc_s) for i in range(len(starts))]
    se = [max(ss[i] + 1, starts[i] + int(lens[i] * perc_e)) for i in range(len(starts))]
    for i in range(len(starts)):
        stage_gt.extend(gt_targets[ss[i] : se[i]])
        stage_pred.extend(pred_scores[ss[i] : se[i]])
    return np.array(stage_gt), np.array(stage_pred)


def perstage_average_precision(
    prediction, ground_truth, class_names, postprocessing=None, metrics="cAP"
) -> OrderedDict:
    result = OrderedDict()
    ground_truth = np.asarray(ground_truth)
    prediction = np.asarray(prediction)
    if postprocessing is not None:
        ground_truth, prediction = postprocessing(ground_truth, prediction)
    compute_score = (
        average_precision if metrics == "AP" else calibrated_average_precision_score
    )
    ignore_index = {0}
    for perc_s in range(10):
        perc_e = perc_s + 1
        stage_name = "{:2}%_{:3}%".format(perc_s * 10, perc_e * 10)
        result[stage_name] = OrderedDict({"per_class_AP": OrderedDict()})
        for idx, class_name in enumerate(class_names):
            if idx in ignore_index:
                continue
            sg, sp = get_stage_pred_scores(
                (ground_truth[:, idx] == 1).astype(int),
                prediction[:, idx],
                perc_s / 10,
                perc_e / 10,
            )
            result[stage_name]["per_class_AP"][class_name] = compute_score(sg, sp)
        result[stage_name]["mean_AP"] = float(
            np.mean(list(result[stage_name]["per_class_AP"].values()))
        )
    return result
