"""The port's parallel/ (tensor, data and sequence parallelism over
torch.distributed) against prego_tpu on the CPU.

Ranks run as spawned processes joined over gloo (``run_ranks``, one
intra-op thread each): 2 ranks for tp, sp and dp, 4 for dp x tp. The
JAX package's references are computed here, in the parent, on one device
(its own tests, tests/test_llama.py:272-345, test_tp_quant.py,
test_tp_serving_paths.py, test_sp_prefill.py and test_orbax_io.py, hold
its mesh equal to its single device); JAX is imported inside fixtures
only, so the ranks, which import this module, never load it. One spawn
serves several checks: each test reads its part of the ranks' results.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from prego_tpu_torch.checkpoint.bridge import llama_from_numpy, miniroad_from_numpy, to_numpy_tree
from prego_tpu_torch.checkpoint.io import tree_leaves
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig, tiny_test_config
from prego_tpu_torch.models.llama.model import (
    forward, fuse_projections, init_cache, init_params, quantize_params,
)
from prego_tpu_torch.parallel import (
    PartitionSpec, llama_cache_specs, llama_param_specs, llama_tp_config, make_mesh,
    run_ranks, shard, shard_params, tp_mesh,
)
from prego_tpu_torch.parallel.sharding import _compatible_spec, check_tp_heads

# f32 everywhere; the tp products sum their partials in another order than
# one device does, over 2 layers of width 64 (tests/test_llama.py's bar)
TOL = dict(rtol=2e-4, atol=2e-4)
# int8 x int8 (K5's plain version: exact int32 sums per rank, each scaled
# in f32, then the f32 partials summed over the ranks, where the JAX package
# sums int32 partials exactly): the f32 summation order only, the bar of
# tests/test_torch_llama_quant.py
QTOL = dict(rtol=1e-4, atol=1e-4)
# int8 weight-only: K4 (and its plain version) rounds its input to bf16, as
# the kernel does. Where the tp sums' f32 order moves an input across a
# bf16 rounding boundary, that input moves one bf16 ulp (2^-8 of it), and
# the logits move by about 2^-8 of their scale at most
Q8_ULPS = 2.0 ** -8
# the train step after one AdamW update (tests/test_torch_train.py's bar)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)

PROMPTS = [[7, 8, 9], [11, 12, 13, 14, 15]]
TRAIN_CFG = {
    "model": "MiniROAD", "task": "OAD", "loss": "NONUNIFORM", "metric": "AP",
    "optimizer": "AdamW", "rgb_type": "rgb_kinetics_bninception",
    "flow_type": "flow_anet_resnet50", "num_classes": 5, "embedding_dim": 32,
    "hidden_dim": 16, "num_layers": 1, "dropout": 0.0, "lr": 3e-3, "weight_decay": 0.05,
    "window_size": 8, "batch_size": 4,
}


def _config(**kw) -> LlamaConfig:
    return dataclasses.replace(tiny_test_config(vocab_size=258), **kw)


def _cfg_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "tp_group"}


def _loaded_jax_modules():
    return sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "prego_tpu" or m.startswith("prego_tpu."))


def _prefill_decode(params, cfg, tokens, cache=None):
    """Logits of a prefill of ``tokens`` and of one greedy decode step after it."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, torch.float32) if cache is None else cache
    pre, cache = forward(params, tokens, 0, cache, cfg)
    nxt = torch.argmax(pre[:, -1:], dim=-1)
    step, _ = forward(params, nxt, S, cache, cfg)
    return pre.numpy(), step.numpy()


# ---- what the ranks run (imported by name in the spawned processes) ----

def _tp2_ranks(payload):
    """Every 2-rank check of this file, in one spawn."""
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
    from prego_tpu_torch.checkpoint import params_io
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.models.llama.speculative import SpeculativeLlama, self_draft
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.parallel.sp import gather_cache, make_sp_prefill
    from prego_tpu_torch.serving_llm import ContinuousBatcher, Request
    from prego_tpu_torch.train import build_optimizer, make_train_step

    cfg = LlamaConfig(**payload["cfg"])
    params = llama_from_numpy(payload["params"])
    tokens = torch.from_numpy(payload["tokens"]).long()
    tok = ByteTokenizer()
    mesh = tp_mesh()
    cfg_tp = llama_tp_config(cfg, mesh)
    local = shard_params(params, llama_param_specs(cfg), mesh)
    out = {"local_shapes": {"wq": tuple(local["layers"][0]["attention"]["wq"].shape),
                            "wo": tuple(local["layers"][0]["attention"]["wo"].shape),
                            "emb": tuple(local["tok_embeddings"].shape),
                            "output": tuple(local["output"].shape),
                            "cache": tuple(init_cache(cfg_tp, 2, torch.float32)["k"][0].shape)}}
    out["tp_forward"] = _prefill_decode(local, cfg_tp, tokens)
    out["greedy"] = Llama(local, tok, cfg_tp).generate(PROMPTS, max_gen_len=6,
                                                       temperature=0.0)[0]
    out["sampled"] = Llama(local, tok, cfg_tp).generate(PROMPTS, max_gen_len=8, temperature=0.8,
                                                        top_p=0.9)[0]
    for mode in ("int8", "int8x8"):
        act = mode == "int8x8"
        q = shard_params(quantize_params(params, activations=act),
                         llama_param_specs(cfg, quantized=True, activations=act), mesh)
        wq, wo = q["layers"][0]["attention"]["wq"], q["layers"][0]["attention"]["wo"]
        out[mode] = {"logits": _prefill_decode(q, cfg_tp, tokens),
                     "shapes": {k: tuple(v.shape) for k, v in (("wq.q", wq["q"]),
                                                                 ("wq.s", wq["s"]),
                                                                 ("wo.q", wo["q"]),
                                                                 ("wo.s", wo["s"]))},
                     "act": "act" in wq}
    # speculative decoding and the cb slot loop in lockstep on both ranks
    target = Llama(local, tok, cfg_tp)
    spec = SpeculativeLlama(target, *self_draft(local, cfg_tp, 1), k=3)
    out["spec"] = spec.generate([[5, 9, 21, 3], [7, 11]], max_gen_len=12, temperature=0.0)
    full = SpeculativeLlama(target, *self_draft(local, cfg_tp, cfg.n_layers), k=3)
    full.generate([[5, 9, 21, 3]], max_gen_len=12, temperature=0.0)
    out["spec_full"] = (full.drafts_accepted, full.drafts_proposed)
    ctx, reqs = payload["cb"]
    cb = ContinuousBatcher(Llama(local, tok, cfg_tp), slots=2, chunk=4, temperature=0.0)
    cb.register_prefix(ctx)
    done, stats = cb.serve([Request(uid=u, prompt=p, max_gen_len=g) for u, p, g in reqs])
    out["cb"] = ({c.uid: c.tokens for c in done}, stats.prefix_hits)
    # a vocabulary tp does not divide: the head stays whole, the logits equal
    odd = dataclasses.replace(cfg, vocab_size=257)
    gen = torch.Generator().manual_seed(5)
    p_odd = init_params(odd, gen, dtype=torch.float32)
    l_odd = shard_params(p_odd, llama_param_specs(odd), mesh)
    want = _prefill_decode(p_odd, odd, tokens)
    got = _prefill_decode(l_odd, llama_tp_config(odd, mesh), tokens)
    out["odd_vocab"] = {"output": tuple(l_odd["output"].shape),
                        "emb": tuple(l_odd["tok_embeddings"].shape),
                        "diff": max(float(np.abs(a - b).max()) for a, b in zip(got, want))}
    try:
        llama_tp_config(dataclasses.replace(cfg, n_kv_heads=1), mesh)
        out["heads"] = None
    except ValueError as e:
        out["heads"] = str(e)
    try:
        forward(shard_params(fuse_projections(params), llama_param_specs(cfg, fused=True), mesh),
                tokens, 0, init_cache(cfg_tp, 2, torch.float32), cfg_tp)
        out["fused"] = None
    except ValueError as e:
        out["fused"] = str(e)
    # sequence-parallel prefill in its three cache layouts
    sp_mesh = make_mesh([("sp", 2)])
    out["sp"] = {}
    for layout in ("sequence", "heads", "replicated"):
        fn = make_sp_prefill(cfg, sp_mesh, cache_sharding=layout)
        logits, cache = fn(params, tokens, 0, init_cache(cfg, 2, torch.float32))
        whole = gather_cache(cache, sp_mesh, cache_sharding=layout)
        nxt = torch.from_numpy(out["tp_forward"][0][:, -1:].argmax(-1))
        step, _ = forward(params, nxt, tokens.shape[1], whole, cfg)
        out["sp"][layout] = {"logits": logits.numpy(), "step": step.numpy(),
                             "leaf_bytes": cache["k"][0].nbytes,
                             "whole_bytes": whole["k"][0].nbytes}
    # the weights cache restored onto the tp mesh, block by block
    restored = params_io.load_llama_params(payload["cache_dir"], cfg, "cpu", torch.float32,
                                           mesh=mesh)
    out["restore_equal"] = all(
        torch.equal(a, b) for a, b in zip(params_io.flat_tensors(restored).values(),
                                          params_io.flat_tensors(local).values()))
    out["restore_keys_equal"] = (list(params_io.flat_tensors(restored))
                                 == list(params_io.flat_tensors(local)))
    try:
        params_io.load_llama_params(payload["cache_dir"], cfg, "cpu", quantized=True, mesh=mesh)
        out["restore_q8"] = None
    except ValueError as e:
        out["restore_q8"] = str(e)
    # TorchLlamaLLM over a Meta checkpoint, tp by default in bf16
    out["llm"] = {}
    for name, kw in (("bf16", {}), ("int8", {"tp": 2, "quantize": "int8"}),
                     ("int8x8", {"tp": 2, "quantize": "int8x8"}),
                     ("int8_default", {"quantize": "int8"})):
        llm = TorchLlamaLLM(ckpt_dir=payload["meta_dir"], tokenizer_path="byte", max_seq_len=64,
                            max_batch_size=2, device="cpu", **kw)
        attn = llm.llama.params["layers"][0]["attention"]
        leaf = attn.get("wq", attn.get("wqkv"))
        out["llm"][name] = {
            "tp": llm.llama.config.tp_size, "layout": sorted(attn),
            "shape": tuple((leaf["q"] if isinstance(leaf, dict) else leaf).shape),
            "act": isinstance(leaf, dict) and "act" in leaf,
            "text": llm.text_completion(["abc"], max_gen_len=4, temperature=0.0)[0]["generation"]}
    # the data-parallel train step over a dp mesh of the same 2 ranks
    rcfg = RecognitionConfig.from_dict(payload["train_cfg"])
    model = MiniROAD(rcfg)
    tparams = miniroad_from_numpy(payload["train_params"])
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    step = make_train_step(model, build_optimizer(rcfg, tparams), flow_is_zero=True,
                           mesh=make_mesh([("dp", 2)]))
    rgb, target, valid = (torch.from_numpy(x) for x in payload["batch"])
    loss = step(tparams, rgb, None, target, valid, None)
    out["train"] = (to_numpy_tree(tparams), float(loss))
    out["modules"] = _loaded_jax_modules()
    return out


def _dp_tp_ranks(payload):
    """dp 2 x tp 2: the batch split over dp, weights and kv heads over tp."""
    cfg = LlamaConfig(**payload["cfg"])
    params = llama_from_numpy(payload["params"])
    mesh = make_mesh([("dp", 2), ("tp", 2)])
    cfg_tp = llama_tp_config(cfg, mesh)
    local = shard_params(params, llama_param_specs(cfg), mesh)
    tokens = torch.from_numpy(payload["tokens"]).long()
    cache = shard_params(init_cache(cfg, tokens.shape[0], torch.float32),
                         llama_cache_specs(cfg, dp_axis="dp"), mesh)
    tokens = shard(mesh, "dp", None).local(tokens)
    out = {"dp": mesh.index("dp"), "tp": mesh.index("tp"),
           "cache": tuple(cache["k"][0].shape),
           "logits": _prefill_decode(local, cfg_tp, tokens, cache)}
    out["absorb"] = make_mesh([("dp", -1), ("tp", 2)]).shape
    for shape in ([("tp", 8)], [("tp", 2)]):
        try:
            make_mesh(shape)
            out[f"mesh {shape}"] = None
        except ValueError as e:
            out[f"mesh {shape}"] = str(e)
    out["modules"] = _loaded_jax_modules()
    return out


# ---- the inputs, the spawns (started first) and the JAX references ----

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The inputs: the JAX package's tiny LLaMA and MiniROAD weights as
    numpy, tokens, cb requests, a train batch whose two halves hold 2 and
    1 valid windows, and the files the ranks read (the port's weights
    cache and a Meta checkpoint of the same LLaMA weights)."""
    import jax
    import jax.numpy as jnp

    from prego_tpu.core import RecognitionConfig as JaxConfig
    from prego_tpu.models.llama import init_params as jax_init_params
    from prego_tpu.models.llama import tiny_test_config as jax_tiny
    from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
    from prego_tpu_torch.checkpoint import params_io
    from tests.test_torch_convert import meta_state, write_meta_dir

    jcfg, cfg = jax_tiny(vocab_size=258), _config()
    jparams = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(21),
                                                       dtype=jnp.float32))
    rng = np.random.default_rng(0)
    out = {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "params": llama_from_numpy(jparams),
           "tokens": rng.integers(0, 256, (2, 8)).astype(np.int32)}
    rng = np.random.default_rng(11)
    out["cb_ctx"] = rng.integers(4, 250, 70).tolist()
    out["cb_reqs"] = [(i, out["cb_ctx"] + rng.integers(4, 250, 3 + i).tolist(), 6)
                      for i in range(5)]
    rng = np.random.default_rng(3)
    out["batch"] = (rng.normal(0, 1, (4, 8, 1024)).astype(np.float32),
                    np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)],
                    np.array([1, 1, 1, 0], np.float32))
    jmodel = JaxMiniROAD(JaxConfig.from_dict(TRAIN_CFG))
    out["train_jparams"] = jmodel.init(jax.random.PRNGKey(11))
    out["train_host"] = jax.tree.map(np.asarray, out["train_jparams"])
    root = tmp_path_factory.mktemp("tp2")
    out["cache_dir"], out["meta_dir"] = str(root / "cache"), str(root / "meta")
    params_io.save_llama_params(out["cache_dir"], out["params"], cfg)
    write_meta_dir(root / "meta", meta_state(out["params"]), 1, cfg)
    return out


@pytest.fixture(scope="module")
def ranks(weights):
    """Both spawns, started at once in threads (they wait on processes), so
    that the ranks run while the JAX references are computed here."""
    from concurrent.futures import ThreadPoolExecutor

    w = weights
    tp2 = {"cfg": _cfg_fields(w["cfg"]), "params": w["jparams"], "tokens": w["tokens"],
           "cb": (w["cb_ctx"], w["cb_reqs"]), "cache_dir": w["cache_dir"],
           "meta_dir": w["meta_dir"], "train_cfg": TRAIN_CFG, "train_params": w["train_host"],
           "batch": w["batch"]}
    dp_tp = {"cfg": _cfg_fields(w["cfg"]), "params": w["jparams"], "tokens": w["tokens"]}
    with ThreadPoolExecutor(2) as pool:
        yield {"tp2": pool.submit(run_ranks, _tp2_ranks, 2, "gloo", "cpu", (tp2,), 1),
               "dp_tp": pool.submit(run_ranks, _dp_tp_ranks, 4, "gloo", "cpu", (dp_tp,), 1)}


@pytest.fixture(scope="module")
def reference(weights, ranks):
    """The JAX package on one device: prefill and a decode step (bf16
    weights in f32, int8, int8 x int8), greedy generation, one train step
    (mesh None)."""
    import jax
    import jax.numpy as jnp

    from prego_tpu.core import RecognitionConfig as JaxConfig
    from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
    from prego_tpu.models.llama import Llama as JaxLlama
    from prego_tpu.models.llama import forward as jax_forward
    from prego_tpu.models.llama import init_cache as jax_init_cache
    from prego_tpu.models.llama.model import quantize_params as jax_quantize
    from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
    from prego_tpu.train import build_optimizer as jax_build_optimizer
    from prego_tpu.train import make_train_step as jax_make_train_step

    jcfg, jparams, tokens = weights["jcfg"], weights["jparams"], weights["tokens"]

    def jax_prefill_decode(p):
        B, S = tokens.shape
        pre, cache = jax_forward(p, jnp.asarray(tokens), jnp.int32(0),
                                 jax_init_cache(jcfg, B, dtype=jnp.float32), jcfg)
        nxt = jnp.argmax(pre[:, -1:], axis=-1).astype(jnp.int32)
        step, _ = jax_forward(p, nxt, jnp.int32(S), cache, jcfg)
        return np.asarray(pre), np.asarray(step), np.asarray(nxt)

    ref = {"forward": jax_prefill_decode(jparams)}
    for mode in ("int8", "int8x8"):
        ref[mode] = jax_prefill_decode(
            jax.tree.map(np.asarray, jax_quantize(jparams, activations=mode == "int8x8")))
    ref["greedy"] = JaxLlama(jparams, JaxByteTokenizer(), jcfg).generate(
        PROMPTS, max_gen_len=6, temperature=0.0)[0]
    jcfg_r = JaxConfig.from_dict(TRAIN_CFG)
    opt = jax_build_optimizer(jcfg_r)
    jstep = jax_make_train_step(JaxMiniROAD(jcfg_r), opt, flow_is_zero=True)
    rgb, target, valid = weights["batch"]
    jp, _, jloss = jstep(weights["train_jparams"], opt.init(weights["train_jparams"]),
                         jnp.asarray(rgb), jnp.zeros((4, 8, 2048), jnp.float32),
                         jnp.asarray(target), jnp.asarray(valid), jax.random.PRNGKey(0))
    ref["train"] = (jax.tree.map(np.asarray, jp), float(jloss))
    return ref


@pytest.fixture(scope="module")
def single(weights, ranks):
    """The port on one device (this process): speculative decoding, the cb
    loop, one train step, and torch-llama over the Meta checkpoint."""
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.models.llama.speculative import SpeculativeLlama, self_draft
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.serving_llm import ContinuousBatcher, Request
    from prego_tpu_torch.train import build_optimizer, make_train_step

    cfg, params = weights["cfg"], weights["params"]
    tok = ByteTokenizer()
    out = {"spec": SpeculativeLlama(Llama(params, tok, cfg), *self_draft(params, cfg, 1),
                                    k=3).generate([[5, 9, 21, 3], [7, 11]], max_gen_len=12,
                                                  temperature=0.0)}
    cb = ContinuousBatcher(Llama(params, tok, cfg), slots=2, chunk=4, temperature=0.0)
    cb.register_prefix(weights["cb_ctx"])
    done, stats = cb.serve([Request(uid=u, prompt=p, max_gen_len=g)
                            for u, p, g in weights["cb_reqs"]])
    out["cb"] = ({c.uid: c.tokens for c in done}, stats.prefix_hits)
    rcfg = RecognitionConfig.from_dict(TRAIN_CFG)
    tparams = miniroad_from_numpy(weights["train_host"])
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    step = make_train_step(MiniROAD(rcfg), build_optimizer(rcfg, tparams), flow_is_zero=True)
    rgb, target, valid = (torch.from_numpy(x) for x in weights["batch"])
    loss = step(tparams, rgb, None, target, valid, None)
    out["train"] = (to_numpy_tree(tparams), float(loss))
    out["llm"] = {}
    for name, kw in (("bf16", {}), ("int8", {"quantize": "int8"}),
                     ("int8x8", {"quantize": "int8x8"})):
        llm = TorchLlamaLLM(ckpt_dir=weights["meta_dir"], tokenizer_path="byte", max_seq_len=64,
                            max_batch_size=2, device="cpu", tp=1, **kw)
        out["llm"][name] = llm.text_completion(["abc"], max_gen_len=4,
                                               temperature=0.0)[0]["generation"]
    return out


@pytest.fixture(scope="module")
def tp2(ranks):
    return ranks["tp2"].result()


@pytest.fixture(scope="module")
def dp_tp(ranks):
    return ranks["dp_tp"].result()


# ---- the checks ----

def test_spawned_ranks_load_neither_jax_nor_the_jax_package(tp2, dp_tp):
    for res in tp2 + dp_tp:
        assert res["modules"] == []


def test_tp_forward_matches_jax(reference, tp2):
    """tests/test_llama.py:272: tp 2 prefill (and a decode step) against one device."""
    want_pre, want_step, _ = reference["forward"]
    for res in tp2:
        np.testing.assert_allclose(res["tp_forward"][0], want_pre, **TOL)
        np.testing.assert_allclose(res["tp_forward"][1], want_step, **TOL)
    shapes = tp2[0]["local_shapes"]
    # column-parallel wq, row-parallel wo, the embedding's dim and the
    # vocabulary split, one kv head of two in each rank's cache
    assert shapes == {"wq": (64, 32), "wo": (32, 64), "emb": (258, 32), "output": (64, 129),
                      "cache": (2, 1, 128, 16)}


def test_dp_tp_forward_and_decode_match_jax(reference, dp_tp):
    """tests/test_llama.py:291: dp 2 x tp 2, the batch of 2 split over dp."""
    want_pre, want_step, _ = reference["forward"]
    assert sorted((r["dp"], r["tp"]) for r in dp_tp) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in dp_tp:
        rows = slice(res["dp"], res["dp"] + 1)
        assert res["cache"] == (1, 1, 128, 16)
        np.testing.assert_allclose(res["logits"][0], want_pre[rows], **TOL)
        np.testing.assert_allclose(res["logits"][1], want_step[rows], **TOL)


def test_make_mesh_sizes(dp_tp):
    """-1 absorbs the remaining ranks; a mesh larger (or smaller) than the world raises."""
    for res in dp_tp:
        assert res["absorb"] == {"dp": 2, "tp": 2}
        assert "needs 8 ranks, have 4" in res["mesh [('tp', 8)]"]
        assert "every rank must be in the mesh" in res["mesh [('tp', 2)]"]


def test_tp_greedy_generate_matches_jax(reference, tp2):
    """tests/test_llama.py:330: tp 2 greedy generation equals one device."""
    for res in tp2:
        assert res["greedy"] == reference["greedy"]


def test_tp_sampled_tokens_equal_on_every_rank(tp2):
    """At temperature 0.8 each rank draws from its own generator, seeded
    alike, over the same all-gathered logits: the tokens agree."""
    a, b = (res["sampled"] for res in tp2)
    assert a == b and any(a)


@pytest.mark.parametrize("mode", ["int8", "int8x8"])
def test_tp_quantized_decode_matches_jax(reference, tp2, mode):
    """tests/test_tp_quant.py: int8 (within a bf16 ulp of K4's input, Q8_ULPS)
    and int8 x int8 (within K5's plain bar, QTOL: f32 partials summed, not
    int32) tp 2 prefill and decode against the JAX package's single device."""
    want_pre, want_step, _ = reference[mode]
    for res in tp2:
        for got, want in zip(res[mode]["logits"], (want_pre, want_step)):
            tol = QTOL if mode == "int8x8" else dict(rtol=0, atol=Q8_ULPS * np.abs(want).max())
            np.testing.assert_allclose(got, want, **tol)
        # column-parallel: q and s split on out; row-parallel: q on in, s whole
        assert res[mode]["shapes"] == {"wq.q": (64, 32), "wq.s": (1, 32), "wo.q": (32, 64),
                                       "wo.s": (1, 64)}
        assert res[mode]["act"] == (mode == "int8x8")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("quantized,activations", [(False, False), (True, False), (True, True)])
def test_param_and_cache_specs_match_jax(fused, quantized, activations):
    """The spec trees are the JAX package's, leaf for leaf, in both layouts."""
    import jax

    from prego_tpu.models.llama import tiny_test_config as jax_tiny
    from prego_tpu.parallel import llama_cache_specs as jax_cache_specs
    from prego_tpu.parallel import llama_param_specs as jax_param_specs

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [plain(v) for v in tree]
        return tuple(tree)

    jcfg, cfg = jax_tiny(vocab_size=258), _config()
    assert plain(llama_param_specs(cfg, quantized=quantized, fused=fused,
                                   activations=activations)) == plain(
        jax_param_specs(jcfg, quantized=quantized, fused=fused, activations=activations))
    for dp_axis in (None, "dp"):
        assert plain(llama_cache_specs(cfg, dp_axis=dp_axis, quantized=quantized)) == plain(
            jax_cache_specs(jcfg, dp_axis=dp_axis, quantized=quantized))
    assert jax.sharding.PartitionSpec(None, "tp") == tuple(PartitionSpec(None, "tp"))


def test_torch_llama_llm_tp_shards(single, tp2):
    """tests/test_tp_quant.py:142, 207: TorchLlamaLLM over a Meta checkpoint
    splits over the 2 ranks (bf16 by default; int8 and int8 x int8 with
    tp=2, unfused) and answers as one device; quantized, tp defaults to 1
    (the fused one-card layout)."""
    for res in tp2:
        llm = res["llm"]
        for name in ("bf16", "int8", "int8x8"):
            assert llm[name]["tp"] == 2
            assert llm[name]["layout"] == ["wk", "wo", "wq", "wv"]
            assert llm[name]["shape"] == (64, 32)
            assert llm[name]["text"] == single["llm"][name]
        assert llm["int8x8"]["act"] and not llm["int8"]["act"]
        assert llm["int8_default"]["tp"] == 1
        assert llm["int8_default"]["layout"] == ["wo", "wqkv"]


def test_tp_speculative_equals_single(single, tp2):
    """tests/test_tp_serving_paths.py: self-1 speculative decoding with the
    target's tp blocks equals the one-device run."""
    for res in tp2:
        assert res["spec"] == single["spec"]


def test_tp_speculative_full_depth_acceptance(tp2):
    for res in tp2:
        accepted, proposed = res["spec_full"]
        assert proposed > 0 and accepted == proposed  # acceptance 1.0


def test_tp_cb_slot_loop_equals_single(single, tp2):
    for res in tp2:
        assert res["cb"] == single["cb"]
        assert res["cb"][1] == 5


def test_sp_prefill_matches_jax(reference, tp2):
    """tests/test_sp_prefill.py: sp 2, each rank's block of the logits, and a
    decode step from the gathered cache, against one device."""
    want_pre, want_step, _ = reference["forward"]
    for rank, res in enumerate(tp2):
        for layout, got in res["sp"].items():
            np.testing.assert_allclose(got["logits"], want_pre[:, 4 * rank:4 * rank + 4], **TOL)
            np.testing.assert_allclose(got["step"], want_step, **TOL)


def test_sp_cache_layouts_scale_memory(tp2):
    """A rank's cache bytes: half in the sequence and heads layouts (kv heads
    2 over sp 2), whole when replicated."""
    for res in tp2:
        shrink = {"sequence": 2, "heads": 2, "replicated": 1}
        for layout, got in res["sp"].items():
            assert got["leaf_bytes"] * shrink[layout] == got["whole_bytes"], layout


def test_sp_prefill_rejects_unknown_cache_sharding():
    from prego_tpu_torch.parallel.sp import make_sp_prefill

    with pytest.raises(ValueError):
        make_sp_prefill(_config(), None, cache_sharding="diagonal")


def test_params_io_restores_onto_tp(tp2):
    """tests/test_orbax_io.py:26: each rank restores its blocks bit for bit;
    :61, a quantized restore onto a mesh raises."""
    for res in tp2:
        assert res["restore_keys_equal"] and res["restore_equal"]
        assert "single-card" in res["restore_q8"]


def test_dp_train_step_matches_single_and_jax(reference, single, tp2):
    """dp 2 with 2 and 1 valid windows: the global masked mean, so the
    params after one step equal the one-process step's and the JAX
    package's (mesh None)."""
    jp, jloss = reference["train"]
    pp, ploss = single["train"]
    import jax

    for res in tp2:
        got, loss = res["train"]
        np.testing.assert_allclose(loss, ploss, **STEP_TOL)
        np.testing.assert_allclose(loss, jloss, **STEP_TOL)
        for g, p, w in zip(jax.tree.leaves(got), jax.tree.leaves(pp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(g, p, **STEP_TOL)
            np.testing.assert_allclose(g, w, **STEP_TOL)


def test_compatible_spec_keeps_an_odd_vocab_whole(tp2):
    """A vocabulary of 257 over tp 2: the head stays whole (the embedding's
    dim still splits), and the logits equal one device's."""
    for res in tp2:
        assert res["odd_vocab"]["output"] == (64, 257)
        assert res["odd_vocab"]["emb"] == (257, 32)
        assert res["odd_vocab"]["diff"] <= 2e-4
    mesh = type("M", (), {"shape": {"tp": 2}})()
    assert _compatible_spec((64, 257), PartitionSpec(None, "tp"), mesh) == (None, None)
    assert _compatible_spec((64, 258), PartitionSpec(None, "tp"), mesh) == (None, "tp")


def test_tp_must_divide_the_heads(tp2):
    """tp 2 over one kv head raises, on the ranks and here."""
    for res in tp2:
        assert "n_kv_heads (1) divisible by 2" in res["heads"]
        assert "unfused layout" in res["fused"]
    with pytest.raises(ValueError, match="divisible by 4"):
        check_tp_heads(_config(), 4)
