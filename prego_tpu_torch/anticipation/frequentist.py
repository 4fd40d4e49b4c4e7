"""Frequentist first-order Markov mistake-detection baseline (port of
prego_tpu/anticipation/frequentist.py; numpy on the host, as there).

Parity surface: step_anticipation/src/data/frequentist_baseline.py:1-107 —
build a transition matrix over distinct one-hot keysteps from the CORRECT
procedures, flag a step in a MISTAKE procedure when its transition
probability from the previous step falls below 1/num_states, and score
with the reference's convention (positive class = "predicted/being
correct": TP means a correct-transition prediction on a truly-correct
step).

Hardcoded expected result for the Assembly101 mistake labels (kept in the
reference as a comment, frequentist_baseline.py:99-107):
Accuracy 0.676, Precision 0.757, Recall 0.740, F1 0.748
(TP 1434, FP 460, FN 505, TN 577).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from prego_tpu_torch.data.mistake_labels import MistakeLabelDataset


def _state_key(row: np.ndarray) -> Tuple:
    return tuple(np.asarray(row).tolist())


def build_transition_matrix(
    correct_procs: Iterable[np.ndarray],
    mistake_procs: Iterable[np.ndarray],
) -> Tuple[np.ndarray, Dict[Tuple, int], float]:
    """States = all distinct step rows (+ an initial all-zeros state);
    rows with no outgoing mass get the uniform threshold value
    (frequentist_baseline.py:28-48)."""
    correct_procs = list(correct_procs)
    mistake_procs = list(mistake_procs)
    dim = correct_procs[0].shape[1] if correct_procs else mistake_procs[0].shape[1]
    initial = _state_key(np.zeros(dim))
    final = _state_key(np.ones(dim))  # legacy padding rows are skipped

    states = set()
    for proc in correct_procs + mistake_procs:
        for row in proc:
            k = _state_key(row)
            if k != final:
                states.add(k)
    all_states: List[Tuple] = [initial] + sorted(states)
    index = {s: i for i, s in enumerate(all_states)}
    n = len(all_states)
    threshold = 1.0 / n

    A = np.zeros((n, n), np.float64)
    for proc in correct_procs:
        prev = initial
        for row in proc:
            k = _state_key(row)
            if k == final:
                continue
            A[index[prev], index[k]] += 1
            prev = k
    row_sums = A.sum(axis=1)
    for i in range(n):
        if row_sums[i] > 0:
            A[i] /= row_sums[i]
        else:
            A[i] = threshold
    return A, index, threshold


def evaluate_frequentist(
    correct: MistakeLabelDataset, mistake: MistakeLabelDataset
) -> Dict[str, float]:
    """Train on correct procedures, score every step of mistake procedures."""
    correct_samples = [p.oh_sample for p in correct.procedures]
    mistake_samples = [p.oh_sample for p in mistake.procedures]
    A, index, threshold = build_transition_matrix(correct_samples, mistake_samples)

    dim = (correct_samples + mistake_samples)[0].shape[1]
    initial = _state_key(np.zeros(dim))
    final = _state_key(np.ones(dim))

    labels: List[int] = []
    gt_labels: List[int] = []
    for proc in mistake.procedures:
        prev = initial
        for row, oh_label in zip(proc.oh_sample, proc.oh_label):
            k = _state_key(row)
            if k == final:
                continue
            p = A[index[prev], index[k]]
            labels.append(0 if p < threshold else 1)
            # gt: 1 = correct step, 0 = correction/mistake
            # (frequentist_baseline.py:60-68)
            gt_labels.append(1 if int(oh_label[0]) == 1 else 0)
            prev = k

    tp = sum(1 for l, g in zip(labels, gt_labels) if l == 1 and g == 1)
    fp = sum(1 for l, g in zip(labels, gt_labels) if l == 1 and g == 0)
    fn = sum(1 for l, g in zip(labels, gt_labels) if l == 0 and g == 1)
    tn = sum(1 for l, g in zip(labels, gt_labels) if l == 0 and g == 0)
    accuracy = (tp + tn) / max(tp + fp + fn + tn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Frequentist Markov baseline")
    parser.add_argument("csv_dir", help="directory of per-video mistake-label CSVs")
    args = parser.parse_args(argv)
    correct = MistakeLabelDataset(args.csv_dir, split="correct")
    mistake = MistakeLabelDataset(args.csv_dir, split="mistake")
    m = evaluate_frequentist(correct, mistake)
    for k in ("accuracy", "precision", "recall", "f1"):
        print(f"{k.capitalize()}: {m[k]}")
    print("TP: {tp}\nFP: {fp}\nFN: {fn}\nTN: {tn}".format(**m))


if __name__ == "__main__":
    main()
