"""The plain references against the port at tiny sizes on the CPU, where
both compute in float32: the decoder's prefill and cached decode against
the reference's full forward, and MiniROAD's train step, loss, gradients
and AdamW update."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY_LLM
from perf_bench import weights
from perf_bench.reference import llama as ref_llama
from perf_bench.reference import miniroad as ref_mr
from perf_bench.reference import quant


def _port_config(max_seq_len=64, max_batch_size=4):
    from perf_bench.loops.anticipate import llama_config

    return llama_config(TINY_LLM, {"max_seq_len": max_seq_len, "max_batch_size": max_batch_size})


@pytest.fixture(scope="module")
def tree():
    return weights.llama_tree(TINY_LLM, 11, "cpu", torch.float32)


def test_prefill_logits_match_the_reference(tree):
    from prego_tpu_torch.models.llama.model import forward, init_cache

    cfg = _port_config()
    seq = list(np.random.default_rng(0).integers(0, 258, 23))
    cache = init_cache(cfg, 1, dtype=torch.float32)
    port, _ = forward(tree, torch.tensor([seq]), 0, cache, cfg)
    ref = ref_llama.logits_at(tree, TINY_LLM, [seq], [list(range(len(seq)))])[0]
    torch.testing.assert_close(port[0], ref, rtol=1e-4, atol=1e-4)


def test_prefill_then_cached_decode_matches_the_full_forward(tree):
    from prego_tpu_torch.models.llama.model import forward, init_cache

    cfg = _port_config()
    seq = [int(x) for x in np.random.default_rng(1).integers(0, 258, 30)]
    cache = init_cache(cfg, 2, dtype=torch.float32)
    toks = torch.tensor([seq[:20], seq[:20]])
    _, cache = forward(tree, toks, 0, cache, cfg)
    decoded = []
    for p in range(20, 30):
        logits, cache = forward(tree, torch.tensor([[seq[p]], [seq[p]]]), p, cache, cfg)
        decoded.append(logits[0, 0])
    ref = ref_llama.logits_at(tree, TINY_LLM, [seq], [list(range(20, 30))])[0]
    torch.testing.assert_close(torch.stack(decoded), ref, rtol=1e-4, atol=1e-4)


def test_served_greedy_tokens_read_no_gap(tree):
    from prego_tpu_torch.models.llama import ByteTokenizer, Llama

    cfg = _port_config(max_seq_len=256, max_batch_size=4)
    llama = Llama(tree, ByteTokenizer(), cfg)
    prompts = [[256] + list(b"Sequence type: toy1\nInput Sequence:\n -1, 12, 40\nNext Symbol:\n"),
               [256] + list(b"Sequence type: toy1\nInput Sequence:\n -1, 12\nNext Symbol:\n")]
    out, _ = llama.generate(prompts, max_gen_len=6, temperature=0.0)
    gaps = ref_llama.served_gaps(tree, TINY_LLM, prompts, out, eos=257, max_gen=6)
    assert max(g for r in gaps for g in r) < 1e-5
    altered = [[(t + 1) % 300 for t in o] for o in out]
    bad = ref_llama.served_gaps(tree, TINY_LLM, prompts, altered, eos=257, max_gen=6)
    assert min(g for r in bad for g in r) > 0


def test_int8_rounding_is_per_column_and_per_row():
    w = torch.tensor([[1.0, -0.5], [0.25, 2.0]])
    q = quant.int8(w, "weight")
    assert torch.equal(q[:, 0].abs().max(), torch.tensor(1.0))
    assert torch.allclose(q, w, atol=2.0 / 127)
    a = quant.int8(w, "act")
    assert torch.allclose(a, w, atol=2.0 / 127)


def test_miniroad_step_matches_the_port(tmp_path):
    """Three AdamW steps of the port's train step (dropout on) and of the
    reference, on the reference's windows of a tiny split."""
    from perf_bench import gen
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.train import build_optimizer, make_train_step

    rc = {"rgb_dim": 1024, "flow_dim": 2048, "embedding_dim": 32, "hidden_dim": 16,
          "num_layers": 1, "num_classes": 5}
    t = {"videos": 3, "frames": [60, 90], "segment_frames": [10, 30], "noise": 1.0,
         "data_name": "X"}
    vids = sorted(gen.write_feature_videos(t, 3, str(tmp_path), "rgb_kinetics_bninception", 5,
                                           1024))
    cfg = RecognitionConfig.from_dict({"rgb_type": "rgb_kinetics_bninception",
                                       "num_classes": 5, "embedding_dim": 32, "hidden_dim": 16,
                                       "window_size": 16, "batch_size": 4})
    batches = ref_mr.first_batches(str(tmp_path), cfg.rgb_type, vids, 16, 4, 4, 3, seed=9)
    tree = weights.miniroad_tree(rc, 5, "cpu")
    p0 = {k: v.detach().clone() for k, v in ref_mr.flat(tree).items()}
    for p in weights.tree_leaves(tree):
        p.requires_grad_(True)
    model = MiniROAD(cfg)
    opt = build_optimizer(cfg, tree)
    step = make_train_step(model, opt, flow_is_zero=True)
    g = torch.Generator().manual_seed(77)
    losses = []
    for rgb, tgt in batches:
        target = torch.as_tensor(tgt)
        losses.append(float(step(tree, torch.as_tensor(rgb), None, target,
                                 torch.ones(len(rgb)), g)))
    r = ref_mr.train(p0, batches, 77, 1.0 - cfg.dropout, cfg.lr, cfg.weight_decay, 1024)
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-5)
    for k, v in ref_mr.flat(tree).items():
        torch.testing.assert_close(v.detach(), r["params"][k], rtol=1e-5, atol=1e-7)
