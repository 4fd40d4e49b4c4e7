"""THUMOS'14 per-frame postprocessing (the port's own copy of
prego_tpu/metrics/postprocessing.py, numpy only).

Parity surface: utils/postprocessing.py:3-28 (the Shou et al. CDC
frame-level protocol): optional 5-frame NMS smoothing, optional
cliff-diving->diving score switch, and removal of ambiguous-class frames.
``None`` for the PREGO datasets (trainer/eval.py:20-22) — present for the
THUMOS benchmark surface.
"""

from __future__ import annotations

import numpy as np


def thumos_postprocessing(
    ground_truth: np.ndarray,
    prediction: np.ndarray,
    smooth: bool = False,
    switch: bool = False,
):
    if smooth:
        prob = np.copy(prediction)
        shifted = [
            prob,
            np.vstack([prob[:1], prob[:-1]]),
            np.vstack([prob[1:], prob[-1:]]),
            np.vstack([prob[:2], prob[:-2]]),
            np.vstack([prob[2:], prob[-2:]]),
        ]
        prediction = np.max(np.stack(shifted, axis=0), axis=0)

    if switch:
        idx = np.where(prediction[:, 5] > prediction[:, 8])[0]
        prediction = np.copy(prediction)
        prediction[idx, 8] = prediction[idx, 5]

    valid = np.where(ground_truth[:, 21] != 1)[0]
    return ground_truth[valid], prediction[valid]
