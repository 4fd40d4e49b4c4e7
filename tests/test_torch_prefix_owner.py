"""``Llama`` owns the prefix cache for every loop that serves it: the plain
``generate_with_prefix_cache``, ``SpeculativeLlama.generate_with_prefix_cache``
and ``ContinuousBatcher.serve_prompts`` / ``register_prefix`` split a batch at
the same shared prefix and leave the same LRU keys in the same order; and
``cut_row`` cuts a row as the inline pad-then-eos cut does. On the tiny
config of the generation-knob tests, with random weights."""

import pytest
import torch

from prego_tpu_torch.models.llama import ByteTokenizer, Llama, init_params, tiny_test_config
from prego_tpu_torch.models.llama.generation import cut_row
from prego_tpu_torch.models.llama.speculative import SpeculativeLlama, self_draft
from prego_tpu_torch.serving_llm import ContinuousBatcher

GEN = 2
# three shared bodies of more than one PREFIX_CHUNK (64), from disjoint bytes
BASES = [[3 + (i * 7 + j) % 60 + 60 * j for i in range(66)] for j in range(3)]
A = BASES[0]
CASES = {
    "below_one_chunk": [A[:40] + [7, 8], A[:40] + [9]],
    "exactly_one_chunk": [A[:64] + [7, 8, 9], A[:64] + [10, 11]],
    "chunk_plus_one_with_one_token_suffix": [A[:65] + [7], A[:65] + [8, 9]],
    "whole_prompt_one_chunk": [A[:64], A[:64]],
}
# a stream that hits, adds and, with two slots, evicts entries
STREAM = [CASES["exactly_one_chunk"], CASES["chunk_plus_one_with_one_token_suffix"],
          [BASES[1][:64] + [5], BASES[1][:64] + [6, 7]], [BASES[2][:65] + [5], BASES[2][:66]],
          CASES["below_one_chunk"], CASES["exactly_one_chunk"]]


@pytest.fixture(scope="module")
def weights():
    cfg = tiny_test_config(vocab_size=258)
    return init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32), cfg


def _llama(weights, slots=4):
    params, cfg = weights
    return Llama(params, ByteTokenizer(), cfg, prefix_cache_slots=slots)


def _inline_rule(prompts, chunk=64):
    """The shared-prefix split as each loop wrote it inline: the longest
    common prefix, one token short of the shortest prompt, rounded down to
    the chunk; 0 below one chunk."""
    common = min(len(t) for t in prompts)
    shared = 0
    while shared < common and all(t[shared] == prompts[0][shared] for t in prompts):
        shared += 1
    eff = (min(shared, common - 1) // chunk) * chunk
    return eff if eff >= chunk else 0


def _serve(loop, llama, prompts):
    """One batch through ``loop``, greedy, over ``llama``'s LRU."""
    if loop == "plain":
        llama.generate_with_prefix_cache(prompts, GEN, temperature=0.0)
    elif loop == "speculative":
        draft, dcfg = self_draft(llama.params, llama.config, 1)
        SpeculativeLlama(llama, draft, dcfg, k=2).generate_with_prefix_cache(
            prompts, GEN, temperature=0.0)
    else:
        ContinuousBatcher(llama, slots=2).serve_prompts(prompts, GEN)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_loop_splits_the_batch_at_the_shared_prefix(weights, case):
    prompts = CASES[case]
    want = _inline_rule(prompts)
    assert _llama(weights).shared_prefix(prompts) == want
    keys = [tuple(prompts[0][:want])] if want else []
    for loop in ("plain", "speculative", "batcher"):
        llama = _llama(weights)
        _serve(loop, llama, prompts)
        assert list(llama._prefix_caches) == keys, loop
    # what serve_prompts registered before: the first prompt cut to the
    # common prefix, one token short of the shortest prompt
    common = min(len(t) for t in prompts)
    shared = next((i for i in range(common) if len({t[i] for t in prompts}) > 1), common)
    cb = ContinuousBatcher(_llama(weights), slots=2)
    assert cb.register_prefix(prompts[0][: min(shared, common - 1)]) == want


@pytest.mark.parametrize("loop", ["speculative", "batcher"])
def test_every_loop_keeps_the_plain_loops_lru(weights, loop):
    """Batch after batch, two slots: the same keys in the same order, and
    the same builds and extensions, as the plain loop."""
    plain, other = _llama(weights, slots=2), _llama(weights, slots=2)
    for prompts in STREAM:
        _serve("plain", plain, prompts)
        _serve(loop, other, prompts)
        assert list(other._prefix_caches) == list(plain._prefix_caches)
    assert len(plain._prefix_caches) == 2
    assert (other.prefix_rebuilds, other.prefix_extends) == (plain.prefix_rebuilds,
                                                             plain.prefix_extends)


def _inline_cut(toks, probs, pad_id, eos_id):
    """The cut each generate wrote inline: at pad, then at eos."""
    if pad_id in toks:
        cut = toks.index(pad_id)
        toks, probs = toks[:cut], probs[:cut]
    if eos_id in toks:
        cut = toks.index(eos_id)
        toks, probs = toks[:cut], probs[:cut]
    return toks, probs


PAD, EOS = ByteTokenizer().pad_id, ByteTokenizer().eos_id


@pytest.mark.parametrize("row", [
    [5, 6, PAD, 7, EOS, 8],  # pad before eos
    [5, EOS, 6, PAD, PAD],  # eos before pad
    [5, 6, 7],  # neither
    [PAD, EOS],  # pad first
    [EOS, 5, PAD],  # eos first
], ids=["pad_before_eos", "eos_before_pad", "neither", "pad_first", "eos_first"])
def test_cut_row_is_the_inline_cut(row):
    probs = [-0.5 * (i + 1) for i in range(len(row))]
    want = _inline_cut(list(row), probs, PAD, EOS)
    assert cut_row(list(row), PAD, EOS, probs) == want
    assert cut_row(list(row), PAD, EOS) == (want[0], None)
