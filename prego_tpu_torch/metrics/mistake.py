"""One-class mistake-detection metrics (the port's own copy of
prego_tpu/metrics/mistake.py, numpy only).

Parity surface: get_metrics, copy-pasted across the three reference LLM
drivers (llama_meta.py:14-58, llm_hf.py:61-98, llm_ollama.py:16-52) — here
implemented once. Benchmark definition (treated as spec, SURVEY.md §7):
every test sequence is a correct procedure EXCEPT its last step, which is a
mistake. A step is "matched" when the recognized step is in the anticipated
set; so

  tn = matched non-last steps      (correct seen as correct)
  fp = unmatched non-last steps    (correct seen as mistake)
  tp = 1 if the last step is unmatched   (mistake caught)
  fn = 1 if the last step is matched     (mistake missed)
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np


def get_metrics(
    preds: Mapping[str, Sequence], gts: Mapping[str, Sequence]
) -> Dict[str, float]:
    tp, fp, fn, tn = 0, 0, 0, 0
    count, samples = 0, 0
    for k in gts.keys():
        gt = gts[k]
        pred = preds[k]
        matches = np.array([g in p for g, p in zip(gt, pred)])

        count += int(np.sum(matches))
        samples += len(matches)
        correct = matches[:-1]
        mistake = matches[-1]

        tn += int(np.sum(correct))
        fp += int(np.sum(~correct))
        tp += int(not mistake)
        fn += int(mistake)

    acc = (tp + tn) / (tp + tn + fp + fn)
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = (
        2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
    )
    ratio = count / samples if samples else 0.0

    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "accuracy": acc,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "ratio": ratio,
        "count": count,
        "samples": samples,
    }
