"""Masked-keystep next-step prediction experiment (port of
prego_tpu/anticipation/masked_keystep.py: the same numpy rng stream, the
same batches and metrics; ``HFMaskedLM`` runs on a device of its own).

Rebuild of the reference's AssemblyTextDataset BERT masked-LM experiment
(step_anticipation/src/data/assembly_text.py:104-160 __main__ block): per
procedure, cut the keystep sequence at a random point, append [MASK] slots
for the next keystep, and ask a masked-LM to fill them. The reference left
the evaluation as a TODO (assembly_text.py:162) and printed completions;
here the loop is completed into a metric (exact / fuzzy next-keystep
accuracy). Its commented-out GPT2 causal variant (assembly_text.py:169-197)
is not rebuilt — the prego_tpu LLaMA/HF anticipation drivers ARE that
experiment, productionized.

The masked-LM is a pluggable callable so the experiment runs hermetically
(HistogramMaskedLM — a frequency oracle over training procedures) or with a
real HF fill-mask checkpoint when weights are available (HFMaskedLM).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

# batches are (history texts, next-keystep ground truth); the fill function
# maps masked texts -> one predicted keystep string per text
FillFn = Callable[[List[str]], List[str]]

NUM_MASKS = 3  # "text + 3 * ' [MASK]'" (assembly_text.py:143)


def sample_history_batch(
    sequences: Sequence[List[str]], rng: np.random.Generator
) -> Dict[str, List]:
    """collate_fn parity (assembly_text.py:104-114): one shared random cut
    n ~ uniform[1, min_len-1) across the batch; history = steps[:n],
    ground truth = steps[n]. Length-1 sequences carry no (history, next)
    pair at all, so they are rejected rather than leaking the answer."""
    if any(len(s) < 2 for s in sequences):
        raise ValueError(
            "sample_history_batch needs every sequence to have >= 2 keysteps "
            "(a length-1 procedure has no next-step ground truth); filter "
            "short procedures out before batching"
        )
    min_n = min(len(s) for s in sequences) - 1
    if min_n < 2:
        n = 1
    else:
        n = int(rng.integers(1, min_n))
    return {
        "hist": [list(s[:n]) for s in sequences],
        "gt": [s[n] for s in sequences],
    }


def build_masked_texts(histories: Sequence[Sequence[str]]) -> List[str]:
    """assembly_text.py:139-144: histories joined by spaces + 3 [MASK] slots."""
    return [" ".join(h) + NUM_MASKS * " [MASK]" for h in histories]


class HistogramMaskedLM:
    """Deterministic hermetic baseline: answer the most frequent keystep
    that FOLLOWS the history's last keystep in the training procedures
    (ties: lexicographic); falls back to the globally most frequent."""

    def __init__(self, train_sequences: Sequence[List[str]]):
        follow: Dict[str, Counter] = {}
        overall: Counter = Counter()
        for seq in train_sequences:
            for a, b in zip(seq, seq[1:]):
                follow.setdefault(a, Counter())[b] += 1
            overall.update(seq)
        self._follow = follow
        self._default = min(
            (k for k, c in overall.items() if c == max(overall.values())),
            default="",
        )

    def __call__(self, masked_texts: List[str]) -> List[str]:
        out = []
        for text in masked_texts:
            hist = [t for t in text.split(" ") if t and t != "[MASK]"]
            last = hist[-1] if hist else ""
            cnt = self._follow.get(last)
            if cnt:
                best = max(cnt.values())
                out.append(min(k for k, c in cnt.items() if c == best))
            else:
                out.append(self._default)
        return out


class HFMaskedLM:
    """Real masked-LM backend (assembly_text.py:126-160): tokenize the
    masked texts, read the [MASK] logits, decode the top-1 tokens and join
    them into a keystep string. Requires local HF weights (no downloads).
    The model and its inputs live on ``device``: the card by default,
    which raises where there is none (``core/device.py``); transformers
    is imported here, on first build, not with the module
    (``anticipation/llm.py::import_transformers``)."""

    def __init__(self, model_checkpoint: str, device: str = "cuda"):
        import torch

        from prego_tpu_torch.anticipation.llm import import_transformers
        from prego_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)  # before the heavy import
        transformers = import_transformers()
        self._torch = torch
        self.tokenizer = transformers.AutoTokenizer.from_pretrained(model_checkpoint)
        self.model = transformers.AutoModelForMaskedLM.from_pretrained(model_checkpoint).to(
            self.device)
        self.model.eval()

    def __call__(self, masked_texts: List[str]) -> List[str]:
        torch = self._torch
        with torch.no_grad():
            inputs = self.tokenizer(masked_texts, return_tensors="pt", padding=True)
            inputs = {k: v.to(self.device) for k, v in inputs.items()}
            logits = self.model(**inputs).logits
        rows, cols = torch.where(inputs["input_ids"] == self.tokenizer.mask_token_id)
        preds: List[List[str]] = [[] for _ in masked_texts]
        top = logits[rows, cols].argmax(-1)
        for r, tok in zip(rows.tolist(), top.tolist()):
            preds[r].append(self.tokenizer.decode([tok]).strip())
        return ["-".join(p) for p in preds]


def run_masked_keystep_experiment(
    train_sequences: Sequence[List[str]],
    test_sequences: Sequence[List[str]],
    fill_fn: Optional[FillFn] = None,
    batch_size: int = 2,
    rounds: int = 8,
    seed: int = 0,
) -> Dict[str, float]:
    """Returns exact and fuzzy (verb-part overlap) next-keystep accuracy.
    Length-1 test procedures have no next-step ground truth and are
    skipped (sample_history_batch rejects them)."""
    fill_fn = fill_fn or HistogramMaskedLM(train_sequences)
    test_sequences = [s for s in test_sequences if len(s) >= 2]
    rng = np.random.default_rng(seed)
    total = exact = fuzzy = 0
    for _ in range(rounds):
        for i in range(0, len(test_sequences), batch_size):
            batch = sample_history_batch(test_sequences[i : i + batch_size], rng)
            preds = fill_fn(build_masked_texts(batch["hist"]))
            for pred, gt in zip(preds, batch["gt"]):
                total += 1
                exact += int(pred == gt)
                got = set(pred.replace("-", " ").split())
                want = set(gt.replace("-", " ").split())
                fuzzy += int(bool(got & want))
    return {
        "samples": total,
        "exact_accuracy": exact / max(total, 1),
        "fuzzy_accuracy": fuzzy / max(total, 1),
    }
