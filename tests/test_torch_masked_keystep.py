"""The masked-keystep experiment, port against prego_tpu: for a seed, the
history batches (the same numpy rng stream), the masked texts, the
HistogramMaskedLM fills and the experiment's accuracies are equal; a tiny
BERT-style masked LM built in memory (nothing downloaded) fills the same
keysteps through HFMaskedLM on the CPU as through the JAX package's."""

import numpy as np
import pytest

from prego_tpu.anticipation import masked_keystep as jax_mk
from prego_tpu_torch.anticipation import masked_keystep

VERBS, PARTS = ["attach", "detach"], ["base", "chassis", "cabin", "roof", "wheel", "boom"]


def _sequences(seed, n, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [[f"{VERBS[rng.integers(2)]}-{PARTS[rng.integers(6)]}-{PARTS[rng.integers(6)]}"
             for _ in range(int(rng.integers(lo, hi)))] for _ in range(n)]


TRAIN, TEST = _sequences(0, 16), _sequences(1, 9)


def test_batches_and_masked_texts_equal():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(0, len(TEST), 3):
        seqs = TEST[i : i + 3]
        got = masked_keystep.sample_history_batch(seqs, rng_a)
        want = jax_mk.sample_history_batch(seqs, rng_b)
        assert got == want
        assert masked_keystep.build_masked_texts(got["hist"]) == jax_mk.build_masked_texts(
            want["hist"])
    with pytest.raises(ValueError, match=">= 2 keysteps"):
        masked_keystep.sample_history_batch([["a-b-c"]], rng_a)


def test_histogram_fills_equal():
    texts = masked_keystep.build_masked_texts([s[:k] for s in TEST for k in (1, 2)])
    texts.append("unseen-step [MASK] [MASK] [MASK]")
    got = masked_keystep.HistogramMaskedLM(TRAIN)(texts)
    assert got == jax_mk.HistogramMaskedLM(TRAIN)(texts)
    assert got[-1] == masked_keystep.HistogramMaskedLM(TRAIN)._default


@pytest.mark.parametrize("seed, batch_size, rounds", [(0, 2, 8), (5, 3, 4)])
def test_experiment_equal(seed, batch_size, rounds):
    test = TEST + [["attach-base-base"]]  # a length-1 procedure is skipped
    got = masked_keystep.run_masked_keystep_experiment(TRAIN, test, batch_size=batch_size,
                                                       rounds=rounds, seed=seed)
    want = jax_mk.run_masked_keystep_experiment(TRAIN, test, batch_size=batch_size,
                                                rounds=rounds, seed=seed)
    assert got == want and got["samples"] == rounds * len(TEST)


@pytest.fixture(scope="module")
def tiny_mlm(tmp_path_factory):
    """A random BERT masked LM with a word-level vocabulary of the keystep
    words, saved with its tokenizer to a local directory."""
    transformers = pytest.importorskip("transformers")
    torch = pytest.importorskip("torch")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = sorted({w for s in TRAIN for k in s for w in k.split("-")} | {"-"})
    vocab = {w: i for i, w in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words])}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]", cls_token="[CLS]",
        sep_token="[SEP]", mask_token="[MASK]")
    cfg = transformers.BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=128)
    torch.manual_seed(0)
    model = transformers.BertForMaskedLM(cfg).eval()
    d = tmp_path_factory.mktemp("tiny_mlm")
    model.save_pretrained(d)
    fast.save_pretrained(d)
    return str(d)


def test_hf_masked_lm_fills_equal(tiny_mlm):
    texts = masked_keystep.build_masked_texts([s[:3] for s in TEST])
    got = masked_keystep.HFMaskedLM(tiny_mlm, device="cpu")(texts)
    assert got == jax_mk.HFMaskedLM(tiny_mlm)(texts)
    assert len(got) == len(texts) and all(got)
    m = masked_keystep.run_masked_keystep_experiment(
        TRAIN, TEST, fill_fn=masked_keystep.HFMaskedLM(tiny_mlm, device="cpu"), rounds=2)
    assert m == jax_mk.run_masked_keystep_experiment(
        TRAIN, TEST, fill_fn=jax_mk.HFMaskedLM(tiny_mlm), rounds=2)


def test_hf_masked_lm_defaults_to_the_card(tiny_mlm):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        masked_keystep.HFMaskedLM(tiny_mlm)
