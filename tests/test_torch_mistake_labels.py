"""Mistake-label datasets and the frequentist Markov baseline, port against
prego_tpu: on synthetic Assembly101-style CSVs made from a seed, the
dataset items (one-hot rows with the this == that quirk, labels, keystep
texts, metadata) and the splits equal bit for bit, the transition matrix
equals bit for bit, the metrics equal, and ``main`` prints the same."""

import csv

import numpy as np
import pytest

from prego_tpu.anticipation import frequentist as jax_freq
from prego_tpu.data import mistake_labels as jax_ml
from prego_tpu_torch.anticipation import frequentist
from prego_tpu_torch.data import mistake_labels


def _write(path, rows, remark):
    fields = ["verb", "this", "that", "label"] + (["remark"] if remark else [])
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow({**r, **({"remark": "-"} if remark else {})})


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    """12 procedures over 3 toys: 5 all-correct, 7 with mistakes and
    corrections; steps drawn from a small pool so transitions repeat, some
    with this == that, a few part names with spaces."""
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("mistake_csvs")
    parts = ["base", "chassis", "cabin", "water tank", "wheel", "roof", "dump bed"]
    pool = [(v, a, b) for v in mistake_labels.VERBS_SORTED for a in parts[:5]
            for b in parts if rng.random() < 0.3] + [("attach", "cabin", "cabin")]
    for i in range(12):
        n = int(rng.integers(3, 9))
        steps = [pool[j] for j in rng.integers(0, len(pool), n)]
        labels = ["correct"] * n
        if i >= 5:
            for j in rng.choice(n, size=int(rng.integers(1, 3)), replace=False):
                labels[j] = str(rng.choice(["mistake", "correction"]))
        rows = [{"verb": v, "this": a, "that": b, "label": lab}
                for (v, a, b), lab in zip(steps, labels)]
        name = f"assembly_nusar-2021_action_user{i % 4}-a0{i % 3 + 1}_nusar_{i:03d}.csv"
        _write(d / name, rows, remark=i % 2 == 0)
    return str(d)


def test_onehot_quirks_equal():
    assert mistake_labels.PARTS_SORTED == jax_ml.PARTS_SORTED
    assert mistake_labels.SAMPLE_DIM == jax_ml.SAMPLE_DIM == 67
    for this, that in (("cabin", "cabin"), ("base", "chassis"), ("water tank", "window")):
        a = mistake_labels.parts_to_onehot(this, that)
        b = jax_ml.parts_to_onehot(this, that)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for v in mistake_labels.VERBS_SORTED:
        assert np.array_equal(mistake_labels.verb_to_onehot(v), jax_ml.verb_to_onehot(v))
    for lab in mistake_labels.LABELS_SORTED:
        assert np.array_equal(mistake_labels.label_to_onehot(lab), jax_ml.label_to_onehot(lab))
    name = "assembly_nusar-2021_action_user3-a02_nusar_011.csv"
    assert (mistake_labels.extract_user_toy_and_id(name)
            == jax_ml.extract_user_toy_and_id(name) == ("user3", "a02", "011"))


@pytest.mark.parametrize("split", ["all", "correct", "mistake"])
def test_dataset_items_equal(csv_dir, split):
    got = mistake_labels.MistakeLabelDataset(csv_dir, split)
    want = jax_ml.MistakeLabelDataset(csv_dir, split)
    assert len(got) == len(want) == {"all": 12, "correct": 5, "mistake": 7}[split]
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for k in ("oh_sample", "oh_label"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
        assert g["keysteps"] == w["keysteps"] and g["metadata"] == w["metadata"]
    assert got.keystep_texts() == want.keystep_texts()
    assert any(" " not in k and "watertank" in k for ks in got.keystep_texts() for k in ks)


def test_explicit_filenames_equal(csv_dir):
    import os

    names = sorted(os.listdir(csv_dir))[::3]
    got = mistake_labels.MistakeLabelDataset(csv_dir, filenames=names)
    want = jax_ml.MistakeLabelDataset(csv_dir, filenames=names)
    assert [p.metadata for p in got.procedures] == [p.metadata for p in want.procedures]


def test_transition_matrix_equal(csv_dir):
    correct = [p.oh_sample for p in mistake_labels.MistakeLabelDataset(csv_dir, "correct").procedures]
    mistake = [p.oh_sample for p in mistake_labels.MistakeLabelDataset(csv_dir, "mistake").procedures]
    A, index, thr = frequentist.build_transition_matrix(correct, mistake)
    jA, jindex, jthr = jax_freq.build_transition_matrix(correct, mistake)
    assert A.dtype == jA.dtype and np.array_equal(A, jA)
    assert index == jindex and thr == jthr


def test_evaluate_frequentist_equal(csv_dir):
    got = frequentist.evaluate_frequentist(
        mistake_labels.MistakeLabelDataset(csv_dir, "correct"),
        mistake_labels.MistakeLabelDataset(csv_dir, "mistake"))
    want = jax_freq.evaluate_frequentist(jax_ml.MistakeLabelDataset(csv_dir, "correct"),
                                         jax_ml.MistakeLabelDataset(csv_dir, "mistake"))
    assert got == want
    assert got["tp"] + got["fp"] + got["fn"] + got["tn"] > 0


def test_main_prints_the_same(csv_dir, capsys):
    frequentist.main([csv_dir])
    got = capsys.readouterr().out
    jax_freq.main([csv_dir])
    want = capsys.readouterr().out
    assert got == want and got.startswith("Accuracy: ") and "TN: " in got
