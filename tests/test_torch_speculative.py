"""Speculative decoding, port against prego_tpu on the JAX tests' tiny
shapes (dim 64, 2 layers, vocab 258, max_seq_len 128, f32), the same numpy
weights through the bridge.

Every case of tests/test_speculative.py is a case here. Greedy: the port's
speculative output equals the port's plain greedy decoding token for token
(any draft, any k, the window edge, eos inside a round, batched rows,
oracle replays, int8 weights, an int8 KV target, the prefix-cached path,
self-drafts), and equals the JAX package's ``SpeculativeLlama`` on the
same weights. Sampled: the first token's distribution within TV 0.2 of the
target's own sampling, and a draft equal to the target accepts every
proposal. ``processed_probs`` equals JAX's on the same logits."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama import ByteTokenizer as JaxByteTokenizer
from prego_tpu.models.llama import LlamaConfig as JaxConfig
from prego_tpu.models.llama import init_params as jax_init_params
from prego_tpu.models.llama.generation import Llama as JaxLlama
from prego_tpu.models.llama.speculative import SpeculativeLlama as JaxSpec
from prego_tpu.models.llama.speculative import self_draft as jax_self_draft
from prego_tpu.ops.sampling import processed_probs as jax_processed_probs
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama.model import quantize_params
from prego_tpu_torch.models.llama.speculative import SpeculativeLlama, _cache_spare, self_draft
from prego_tpu_torch.ops.sampling import processed_probs, sample_next_token
from tests.torch_parity import n, t



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: under pytest-xdist each
    worker otherwise starts a thread per core, and the oversubscribed
    threads cost far more than they save at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _configs(**kw):
    base = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=4, vocab_size=258, multiple_of=32,
                norm_eps=1e-5, max_batch_size=4, max_seq_len=128)
    base.update(kw)
    return JaxConfig(**base), LlamaConfig(**base)


def _params(seed, **kw):
    """(numpy f32 tree, JAX config, port config) of a random model."""
    jcfg, tcfg = _configs(**kw)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed),
                                                    dtype=jnp.float32))
    return tree, jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """The target (seed 0) and a different, smaller draft (seed 7, near-zero
    agreement with the target), each as JAX's and the port's."""
    tree, jcfg, tcfg = _params(0)
    dtree, djcfg, dtcfg = _params(7, dim=32, n_layers=1, n_heads=2, n_kv_heads=2)
    return {
        "jax": JaxLlama(tree, JaxByteTokenizer(), jcfg),
        "port": Llama(llama_from_numpy(tree), ByteTokenizer(), tcfg),
        "jax_draft": (dtree, djcfg),
        "port_draft": (llama_from_numpy(dtree), dtcfg),
    }


def _spec(models, k):
    return SpeculativeLlama(models["port"], *models["port_draft"], k=k)


def _plain(llama, prompts, gen, **kw):
    return llama.generate([list(p) for p in prompts], max_gen_len=gen, temperature=0.0, **kw)[0]


# ------------------------------------------------ greedy: equal to plain decoding

@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_greedy_equals_plain_for_any_draft(models, k):
    spec = _spec(models, k)
    for prompt in ([5, 9, 21, 3], [7], list(range(4, 40))):
        want = _plain(models["port"], [prompt], 24)
        assert spec.generate([list(prompt)], max_gen_len=24, temperature=0.0) == want, (k, prompt[:4])
    assert spec.drafts_proposed == spec.rounds * k  # one row, active every round


@pytest.mark.parametrize("k", [2, 4])
def test_window_boundary_emits_full_budget(models, k):
    """A prompt + budget that fills the window emits what plain decoding
    emits: rows frozen at pos + k + 1 > max_seq_len finish on the plain
    tail, alone and beside a short row."""
    cfg = models["port"].config
    spec = _spec(models, k)
    rng = np.random.default_rng(31)
    for plen in (cfg.max_seq_len - 44, cfg.max_seq_len - 7):
        prompt = rng.integers(4, 250, plen).tolist()
        budget = cfg.max_seq_len - plen
        for prompts in ([prompt], [prompt, [5, 9]]):
            want = _plain(models["port"], prompts, budget)
            got = spec.generate([list(p) for p in prompts], max_gen_len=budget, temperature=0.0)
            assert got == want, (k, plen, len(prompts))
            assert len(got[0]) == budget


def test_cache_spare_tail():
    """k + 1 spare positions where max_seq_len is no multiple of 256, else
    256; the port's caches take them on their T axis."""
    _, tcfg = _configs()
    assert _cache_spare(tcfg, 4) == 5
    _, long_cfg = _configs(max_seq_len=512)
    assert _cache_spare(long_cfg, 4) == 256
    tree, _, tcfg = _params(0)
    lm = Llama(llama_from_numpy(tree), ByteTokenizer(), tcfg, kv_quant=True)
    cache = lm._new_cache(2, spare=5)
    assert cache["k"][0]["q"].shape == (2, 4, 133, 16) and cache["k"][0]["s"].shape == (2, 4, 133)


def test_greedy_oracle_replay_full_acceptance(models):
    """The target's own greedy continuation as the draft: every proposal
    accepted, about gen / k rounds."""
    prompt, gen = [5, 9, 21, 3], 24
    want = _plain(models["port"], [prompt], gen)
    spec = SpeculativeLlama(models["port"], k=4)
    got = spec.generate([list(prompt)], max_gen_len=gen, temperature=0.0,
                        oracle_tokens=[prompt + want[0]])
    assert got == want
    assert spec.rounds <= -(-gen // 4) + 1
    assert spec.drafts_accepted >= spec.rounds * 4 - 4


def test_eos_mid_round_truncates(models):
    """An eos accepted inside a round ends the row there: the oracle replays
    the greedy continuation, whose sixth token is made the tokenizer's eos,
    so a round of full acceptance holds it in its middle."""
    tl, jl = models["port"], models["jax"]
    prompt, gen = [5, 9, 21, 3], 24
    cont = _plain(tl, [prompt], gen)[0]
    eos = cont[5]
    assert eos not in cont[:5]  # the cut falls at index 5, inside round 2
    tok, jtok = ByteTokenizer(), JaxByteTokenizer()
    tok.eos_id = jtok.eos_id = eos
    tl2 = Llama(tl.params, tok, tl.config)
    jl2 = JaxLlama(jl.params, jtok, jl.config)
    want = _plain(tl2, [prompt], gen)
    assert want == [cont[:5]]
    spec = SpeculativeLlama(tl2, k=4)
    got = spec.generate([list(prompt)], max_gen_len=gen, temperature=0.0,
                        oracle_tokens=[prompt + cont])
    assert got == want and spec.rounds == 2  # 5 tokens, then eos at index 0 of round 2
    jspec = JaxSpec(jl2, k=4)
    assert jspec.generate([list(prompt)], max_gen_len=gen, temperature=0.0,
                          oracle_tokens=[prompt + cont]) == got
    # with a draft, the same cut; max_gen_len 1 cuts a round to one token
    spec_d = SpeculativeLlama(tl2, *models["port_draft"], k=5)
    assert spec_d.generate([list(prompt)], max_gen_len=gen, temperature=0.0) == want
    one = spec_d.generate([[5, 9]], max_gen_len=1, temperature=0.0)
    assert one == _plain(tl2, [[5, 9]], 1) and len(one[0]) <= 1


def test_batched_rows_equal_plain(models):
    """Rows of different prompt lengths accept different counts a round and
    still each emit their plain greedy tokens; batches past max_batch_size
    split as in ``Llama.generate``."""
    spec = _spec(models, 3)
    prompts = [[5, 9, 21], [7, 4], [30, 31, 32, 33], [11]]
    assert spec.generate([list(p) for p in prompts], 12, 0.0) == _plain(models["port"], prompts, 12)
    spec2 = _spec(models, 2)
    six = [[5 + i, 9, 21] for i in range(6)]
    assert spec2.generate([list(p) for p in six], 6, 0.0) == _plain(models["port"], six, 6)


def test_batched_oracle_per_row_replays(models):
    """One row replays its true continuation (full acceptance), the other
    garbage (none): both emit their plain greedy tokens."""
    prompts = [[5, 9, 21, 3], [7, 4, 18]]
    want = _plain(models["port"], prompts, 10)
    spec = SpeculativeLlama(models["port"], k=4)
    got = spec.generate([list(p) for p in prompts], max_gen_len=10, temperature=0.0,
                        oracle_tokens=[prompts[0] + want[0], prompts[1] + [99] * 12])
    assert got == want


def test_greedy_with_int8_target(models):
    """Weight-only int8 target params through the rounds equal the same
    model's plain greedy, with a separate draft and with a self-draft over
    the same int8 leaves."""
    tl = models["port"]
    q_llama = Llama(quantize_params(tl.params), ByteTokenizer(), tl.config)
    want = _plain(q_llama, [[5, 9, 21, 3]], 16)
    spec = SpeculativeLlama(q_llama, *models["port_draft"], k=4)
    assert spec.generate([[5, 9, 21, 3]], 16, 0.0) == want
    sd_params, sd_cfg = self_draft(q_llama.params, tl.config, 1)
    spec_self = SpeculativeLlama(q_llama, sd_params, sd_cfg, k=4)
    assert spec_self._self_draft_layers == 1
    assert spec_self.generate([[5, 9, 21, 3]], 16, 0.0) == want


def test_greedy_with_quantized_kv_target(models):
    """An int8 KV target: the rounds equal plain greedy on the same int8
    cache kind, the draft's caches follow the target's (int8), and the
    prefix-cached path equals the plain one."""
    tl = models["port"]
    q_target = Llama(tl.params, ByteTokenizer(), tl.config, kv_quant=True)
    spec = SpeculativeLlama(q_target, *models["port_draft"], k=3)
    assert spec._draft_llama.kv_quant
    prompt = [5, 9, 21, 3, 17]
    assert spec.generate([list(prompt)], 16, 0.0) == _plain(q_target, [prompt], 16)
    text = ByteTokenizer().decode(prompt)
    out = spec.text_completion([text], max_gen_len=16, temperature=0.0, use_prefix_cache=True)
    assert out[0]["generation"] == q_target.text_completion([text], max_gen_len=16,
                                                            temperature=0.0)[0]["generation"]
    # a shared prefix long enough for the LRU, through int8 prefix caches
    base = [4 + (i % 90) for i in range(70)]
    prompts = [base + [100, 101], base + [102]]
    assert spec.generate_with_prefix_cache([list(p) for p in prompts], 8, 0.0) == \
        q_target.generate_with_prefix_cache([list(p) for p in prompts], 8, temperature=0.0)
    assert spec._draft_llama.prefix_rebuilds == 1


def test_prefix_cached_spec_equals_prefix_cached_plain(models):
    """Both models resume from their own B=1 prefix caches: output equals
    the plain prefix-cached path's, the target's LRU entry is shared with
    it, the draft builds its own once; short prompts fall back to the plain
    speculative path."""
    tl = models["port"]
    spec = _spec(models, 3)
    base = [4 + (i % 90) for i in range(70)]
    prompts = [base + [100, 101], base + [102], base + [103, 104, 105]]
    tl.prefix_rebuilds = tl.prefix_extends = 0
    tl._prefix_caches.clear()
    want = tl.generate_with_prefix_cache([list(p) for p in prompts], max_gen_len=10,
                                         temperature=0.0)
    assert spec.generate_with_prefix_cache([list(p) for p in prompts], 10, 0.0) == want
    assert tl.prefix_rebuilds == 1 and spec._draft_llama.prefix_rebuilds == 1
    short = [[5, 9], [7, 4, 2]]
    assert spec.generate_with_prefix_cache([list(p) for p in short], 6, 0.0) == \
        tl.generate_with_prefix_cache([list(p) for p in short], 6, temperature=0.0)


def test_self_draft_truncated_greedy_equals_plain(models):
    """A 1-layer self-draft holds the target's own tensors (nothing copied)
    and leaves greedy output as plain decoding's, plain and prefix-cached."""
    tl = models["port"]
    d_params, d_cfg = self_draft(tl.params, tl.config, 1)
    assert d_cfg.n_layers == 1
    assert d_params["layers"][0] is tl.params["layers"][0]
    assert d_params["output"] is tl.params["output"]
    spec = SpeculativeLlama(tl, d_params, d_cfg, k=3)
    assert spec._self_draft_layers == 1
    assert spec._draft_llama.params["tok_embeddings"] is tl.params["tok_embeddings"]
    for prompt in ([5, 9, 21, 3], list(range(4, 40))):
        assert spec.generate([list(prompt)], 16, 0.0) == _plain(tl, [prompt], 16)
    base = [4 + (i % 90) for i in range(70)]
    prompts = [base + [100, 101], base + [102]]
    assert spec.generate_with_prefix_cache([list(p) for p in prompts], 8, 0.0) == \
        tl.generate_with_prefix_cache([list(p) for p in prompts], 8, temperature=0.0)


def test_self_draft_full_depth_accepts_nearly_all(models):
    """The full-depth self-draft is the target: acceptance ~1 (the single-
    token draft and the k+1-token verify differ only at near-ties)."""
    tl = models["port"]
    spec = SpeculativeLlama(tl, *self_draft(tl.params, tl.config, tl.config.n_layers), k=4)
    assert spec.generate([[5, 9, 21, 3]], 24, 0.0) == _plain(tl, [[5, 9, 21, 3]], 24)
    assert spec.drafts_accepted >= 0.8 * (spec.rounds * 4 - 4)


def test_self_draft_depth_bounds(models):
    tl = models["port"]
    for bad in (0, tl.config.n_layers + 1):
        with pytest.raises(ValueError):
            self_draft(tl.params, tl.config, bad)


# ------------------------------------------------ greedy: equal to the JAX package

def test_greedy_matches_jax(models):
    """The port's SpeculativeLlama and JAX's on the same weights and draft:
    the same tokens and the same round and acceptance counts."""
    spec = _spec(models, 3)
    jspec = JaxSpec(models["jax"], *models["jax_draft"], k=3)
    prompts = [[5, 9, 21], [7, 4], [30, 31, 32, 33], [11]]
    got = spec.generate([list(p) for p in prompts], 12, 0.0)
    assert got == jspec.generate([list(p) for p in prompts], max_gen_len=12, temperature=0.0)
    assert (spec.rounds, spec.drafts_accepted, spec.drafts_proposed) == \
        (jspec.rounds, jspec.drafts_accepted, jspec.drafts_proposed)


def test_window_edge_matches_jax(models):
    cfg = models["port"].config
    prompt = np.random.default_rng(31).integers(4, 250, cfg.max_seq_len - 7).tolist()
    spec = _spec(models, 4)
    jspec = JaxSpec(models["jax"], *models["jax_draft"], k=4)
    for prompts in ([prompt], [prompt, [5, 9]]):
        got = spec.generate([list(p) for p in prompts], 7, 0.0)
        assert got == jspec.generate([list(p) for p in prompts], max_gen_len=7, temperature=0.0)
        assert len(got[0]) == 7


def test_prefix_cached_and_self_draft_match_jax(models):
    """The prefix-cached path with a separate draft, and a 1-layer
    self-draft on both paths, against JAX's."""
    tl, jl = models["port"], models["jax"]
    base = [4 + (i % 90) for i in range(70)]
    prompts = [base + [100, 101], base + [102], base + [103, 104, 105]]
    spec = _spec(models, 3)
    jspec = JaxSpec(jl, *models["jax_draft"], k=3)
    got = spec.generate_with_prefix_cache([list(p) for p in prompts], 10, 0.0)
    assert got == jspec.generate_with_prefix_cache([list(p) for p in prompts], max_gen_len=10,
                                                   temperature=0.0)
    assert spec.drafts_accepted == jspec.drafts_accepted
    s_spec = SpeculativeLlama(tl, *self_draft(tl.params, tl.config, 1), k=3)
    j_spec = JaxSpec(jl, *jax_self_draft(jl.params, jl.config, 1), k=3)
    assert j_spec._self_draft_layers == s_spec._self_draft_layers == 1
    for gen in (s_spec.generate, s_spec.generate_with_prefix_cache):
        jgen = getattr(j_spec, gen.__name__)
        assert gen([list(p) for p in prompts], 8, 0.0) == \
            jgen([list(p) for p in prompts], max_gen_len=8, temperature=0.0)


# ------------------------------------------------ sampled mode

def test_sampled_preserves_target_distribution(models):
    """With a wrong draft, the first token still follows the target's
    processed distribution (temperature + nucleus): TV distance < 0.2 over
    600 draws against the target's own sampling."""
    tl = models["port"]
    prompt, N = [5, 9, 11], 600
    temperature, top_p = 0.25, 0.9
    spec = _spec(models, 2)
    outs = spec.generate([list(prompt)] * N, max_gen_len=1, temperature=temperature, top_p=top_p)
    spec_first = [o[0] if o else tl.tokenizer.eos_id for o in outs]
    plain, _ = tl.generate([list(prompt)] * N, max_gen_len=1, temperature=temperature, top_p=top_p)
    gen_first = [o[0] if o else tl.tokenizer.eos_id for o in plain]
    support = sorted(set(spec_first) | set(gen_first))
    assert len(support) > 1, "degenerate distribution: the test would be vacuous"
    pa, pb = collections.Counter(spec_first), collections.Counter(gen_first)
    tv = 0.5 * sum(abs(pa[x] - pb[x]) / N for x in support)
    assert tv < 0.2, (tv, pa.most_common(5), pb.most_common(5))


def test_sampled_self_draft_accepts_everything(models):
    """A draft equal to the target: q == p, every proposal accepted."""
    tl = models["port"]
    spec = SpeculativeLlama(tl, tl.params, tl.config, k=4)
    out = spec.generate([[5, 9, 21, 3]], max_gen_len=24, temperature=0.7, top_p=0.9)
    assert len(out[0]) >= 1
    assert spec.drafts_accepted >= spec.rounds * 4 - 4, (spec.drafts_accepted, spec.rounds)


def test_processed_probs_matches_jax_and_the_sampler():
    """Within 1e-6 of JAX's processed_probs on the same logits, summing to
    1, and the distribution the port's sampler draws from: the empirical
    frequencies of 2000 draws within 0.05, the cut tokens never drawn."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 2.0).astype(np.float32)
    for temperature, top_p in ((0.8, 0.7), (0.25, 0.9), (1.0, 1.0)):
        want = np.asarray(jax_processed_probs(jnp.asarray(logits), temperature, top_p))
        got = n(processed_probs(t(logits), temperature, top_p))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    p = n(processed_probs(t(logits[:1, :16]), 0.8, 0.7))[0]
    gen = torch.Generator().manual_seed(0)
    draws = sample_next_token(t(np.repeat(logits[:1, :16], 2000, axis=0)), 0.8, 0.7, gen)
    emp = np.bincount(draws.numpy(), minlength=16) / 2000
    assert np.abs(emp - p).max() < 0.05
    assert all(emp[i] == 0 for i in range(16) if p[i] == 0)


def test_spec_needs_a_draft_or_an_oracle(models):
    tl = models["port"]
    with pytest.raises(ValueError, match="draft_params or oracle_tokens"):
        SpeculativeLlama(tl, k=2).generate([[5, 9]], 4, 0.0)
    with pytest.raises(ValueError, match="greedy-only"):
        SpeculativeLlama(tl, k=2).generate([[5, 9]], 4, 0.5, oracle_tokens=[[5, 9, 1]])
    _, small = _configs(max_seq_len=64)
    with pytest.raises(ValueError, match="cover"):
        SpeculativeLlama(tl, tl.params, small, k=2)


# ------------------------------------------------ the LLM adapter and the CLI

def _llm_pair(**kw):
    """JAX's jax-llama and the port's torch-llama on the same fabricated
    tiny weights, each with ``kw``."""
    from prego_tpu.anticipation.llm import JaxLlamaLLM
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    jllm = JaxLlamaLLM(ckpt_dir="", tokenizer_path="", fabricated="tiny", max_seq_len=256, **kw)
    jcfg = jllm.llama.config
    tllm = TorchLlamaLLM(params=llama_from_numpy(jax.tree.map(np.asarray, jllm.llama.params)),
                         config=LlamaConfig(**{f: getattr(jcfg, f)
                                               for f in jcfg.__dataclass_fields__}),
                         device="cpu", **kw)
    return jllm, tllm


PROMPTS = ["step 1, step 2, step 3\n" * 4 + "4", "step 1, step 2, step 3\n" * 4 + "5 6"]


def test_llm_self_draft_matches_jax_and_plain():
    """torch-llama with spec_k 2 and a self-1 draft: the completions of
    jax-llama with the same flags and of the plain path, the prefix cache
    on (the prompts share 96 tokens), and the same round counts."""
    jllm, tllm = _llm_pair(spec_k=2, spec_draft="self-1")
    got = tllm.text_completion(PROMPTS, max_gen_len=8, temperature=0.0)
    assert got == jllm.text_completion(PROMPTS, max_gen_len=8, temperature=0.0)
    assert got == tllm.llama.text_completion(PROMPTS, max_gen_len=8, temperature=0.0,
                                             use_prefix_cache=True)
    spec, jspec = tllm._spec, jllm._spec
    assert spec._self_draft_layers == 1 and spec._draft_llama.prefix_rebuilds == 1
    assert (spec.rounds, spec.drafts_accepted, spec.drafts_proposed) == \
        (jspec.rounds, jspec.drafts_accepted, jspec.drafts_proposed)


def test_llm_fabricated_and_checkpoint_drafts(tmp_path):
    """A fabricated-tiny draft (random, the target's vocabulary and window)
    and a Meta checkpoint dir draft: greedy output is the plain path's."""
    from tests.test_torch_convert import meta_state, write_meta_dir

    _, tllm = _llm_pair(spec_k=3, spec_draft="fabricated-tiny")
    want = tllm.llama.text_completion(PROMPTS, max_gen_len=6, temperature=0.0)
    assert tllm.text_completion(PROMPTS, max_gen_len=6, temperature=0.0) == want
    d_cfg = tllm._spec.draft_config
    assert (d_cfg.vocab_size, d_cfg.max_seq_len, d_cfg.dim) == (258, 256, 64)
    assert tllm._spec._self_draft_layers == 0
    tree, _, dcfg = _params(7, dim=32, n_layers=1, n_heads=2, n_kv_heads=2)
    d = write_meta_dir(tmp_path / "draft", meta_state(llama_from_numpy(tree)), 1, dcfg)
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    ck = TorchLlamaLLM(params=tllm.llama.params, config=tllm.llama.config, device="cpu",
                       spec_k=3, spec_draft=str(d))
    assert ck.text_completion(PROMPTS, max_gen_len=6, temperature=0.0) == want
    assert ck._spec.draft_config.dim == 32 and ck._spec.drafts_proposed > 0


def test_llm_auto_off_guard(capsys, monkeypatch):
    """A random draft sampled at k 4: once 256 proposals are judged, an
    acceptance below 1/k turns speculation off with the JAX adapter's
    message, and later calls run the plain path."""
    monkeypatch.delenv("PREGO_SPEC_MIN_ACCEPT", raising=False)
    _, tllm = _llm_pair(spec_k=4, spec_draft="fabricated-tiny", max_batch_size=8)
    calls = 0
    while not tllm._spec_disabled:
        tllm.text_completion(PROMPTS * 4, max_gen_len=16, temperature=0.7)
        calls += 1
        assert calls < 10
    spec = tllm._spec
    assert spec.drafts_proposed >= 256 and spec.drafts_accepted < spec.drafts_proposed / 4
    err = capsys.readouterr().err
    assert "speculative decoding auto-disabled" in err and "continuing on the plain path" in err
    proposed = spec.drafts_proposed
    tllm.text_completion(PROMPTS, max_gen_len=4, temperature=0.7)
    assert spec.drafts_proposed == proposed
    monkeypatch.setenv("PREGO_SPEC_MIN_ACCEPT", "0")
    _, off = _llm_pair(spec_k=4, spec_draft="fabricated-tiny", max_batch_size=8)
    assert off._spec_min_accept == 0.0


def test_llm_spec_refusals():
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    kw = dict(fabricated="tiny", max_seq_len=128, device="cpu")
    for bad in (dict(spec_k=2), dict(spec_draft="self-1")):
        with pytest.raises(ValueError, match="spec_k and spec_draft must be set together"):
            TorchLlamaLLM(**kw, **bad)
    with pytest.raises(ValueError, match="incompatible with --serving cb"):
        TorchLlamaLLM(**kw, spec_k=2, spec_draft="self-1", serving="cb")


@pytest.mark.parametrize("flags, message", [
    (["--spec_k", "2"], "--spec_k and --spec_draft must be set together"),
    (["--spec_draft", "self-1"], "--spec_k and --spec_draft must be set together"),
    (["--spec_k", "2", "--spec_draft", "self-1", "--serving", "cb"],
     "--spec_k rides the batch path: speculative decoding is incompatible with --serving cb"),
])
def test_cli_spec_refusals(flags, message):
    from prego_tpu_torch.cli import anticipate

    args = anticipate.parse_args(["--llm", "torch-llama", "--fabricated", "tiny", *flags])
    with pytest.raises(SystemExit) as exc:
        anticipate.llm_kwargs(args)
    assert str(exc.value) == message


def test_cli_passes_the_spec_flags():
    from prego_tpu_torch.cli import anticipate

    args = anticipate.parse_args(["--llm", "torch-llama", "--fabricated", "tiny", "--spec_k", "4",
                                  "--spec_draft", "self-8"])
    kw = anticipate.llm_kwargs(args)
    assert (kw["spec_k"], kw["spec_draft"]) == (4, "self-8")
