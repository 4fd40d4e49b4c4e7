"""A whole tiny run, past the harness's look for a card, with the timed
path broken underneath: ``correct`` must come out false for each fault
the cell can have, and true for the sound program."""

from __future__ import annotations

import pytest
import torch

from perf_bench import run


def _run(bench, name, seed=5, seconds=1.5):
    return run.run_cell(bench, name, seed, seconds, False, torch.device("cpu"))


def test_sound_runs_are_correct(tiny_bench):
    for w in tiny_bench.spec["workloads"]:
        out = _run(tiny_bench, w["name"])
        assert out["correct"], (w["name"], out["checks"])


def _altered_token(monkeypatch):
    from prego_tpu_torch.models.llama import generation

    orig = generation.sample_next_token

    def altered(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(generation, "sample_next_token", altered)


def _half_batch_served(monkeypatch):
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    orig = TorchLlamaLLM.text_completion

    def half(self, prompts, *a, **k):
        h = max(1, len(prompts) // 2)
        out = orig(self, prompts[:h], *a, **k)
        return out + out[: len(prompts) - h]  # the rest answered with copies

    monkeypatch.setattr(TorchLlamaLLM, "text_completion", half)


def _decode_state_unchanged(monkeypatch):
    from prego_tpu_torch.models.llama import generation
    from prego_tpu_torch.models.llama.model import clone_cache

    orig = generation.forward

    def frozen(params, tokens, start_pos, cache, *a, **k):
        if tokens.shape[1] == 1:  # a decode step that leaves the cache as it was
            logits, _ = orig(params, tokens, start_pos, clone_cache(cache), *a, **k)
            return logits, cache
        return orig(params, tokens, start_pos, cache, *a, **k)

    monkeypatch.setattr(generation, "forward", frozen)


@pytest.mark.parametrize("fault", [_altered_token, _half_batch_served, _decode_state_unchanged])
def test_anticipation_faults_are_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_bench, "anticipate-mistral7b")
    assert not out["correct"], out["checks"]


def _optimizer_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_batch_loss(monkeypatch):
    from prego_tpu_torch.train import trainer

    orig = trainer.last_frame_mlce

    def half(logits, target, valid=None):
        h = logits.shape[0] // 2
        return orig(logits[:h], target[:h], None if valid is None else valid[:h])

    monkeypatch.setattr(trainer, "last_frame_mlce", half)


@pytest.mark.parametrize("fault", [_optimizer_state_unchanged, _half_batch_loss])
def test_training_faults_are_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_bench, "train-miniroad-asm101")
    assert not out["correct"], out["checks"]


def _stream_rows_left_out(monkeypatch):
    from prego_tpu_torch.models.miniroad import MiniROAD

    orig = MiniROAD.forward_step

    def half(self, params, rgb_t, *a, **k):
        h = rgb_t.shape[0] // 2
        rgb_t = torch.cat([rgb_t[:h], rgb_t[:rgb_t.shape[0] - h]])  # the rest read as the first half
        return orig(self, params, rgb_t, *a, **k)

    monkeypatch.setattr(MiniROAD, "forward_step", half)


def _recognizer_state_unchanged(monkeypatch):
    from prego_tpu_torch.models.miniroad import MiniROAD

    orig = MiniROAD.forward_step

    def frozen(self, params, rgb_t, flow_t, hidden, *a, **k):
        scores, _ = orig(self, params, rgb_t, flow_t, hidden, *a, **k)
        return scores, hidden

    monkeypatch.setattr(MiniROAD, "forward_step", frozen)


def _vote_altered(monkeypatch):
    from prego_tpu_torch import serving

    orig = serving._make_detector_block_fn

    def make(*a, **k):
        fn = orig(*a, **k)

        def altered(*args):
            (cls, done, winner), *rest = fn(*args)
            return ((cls, done, (winner + 1) % 5), *rest)

        return altered

    monkeypatch.setattr(serving, "_make_detector_block_fn", make)


@pytest.mark.parametrize("fault", [_altered_token, _stream_rows_left_out,
                                   _recognizer_state_unchanged, _vote_altered])
def test_online_faults_are_not_correct(tiny_bench, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny_bench, "online-mistral7b", seconds=2.0)
    assert not out["correct"], out["checks"]
