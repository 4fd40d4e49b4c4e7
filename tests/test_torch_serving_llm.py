"""Per-row decode positions and the continuous-batching server, port
against prego_tpu on a tiny config, the same numpy weights through the
bridge.

Per-row ``forward`` is held against the JAX package's per-row forward
(plain and int8 KV cache, S = 1 and S > 1, equal and mixed positions), and
with every entry equal against the port's scalar forward, bit for bit.
Every test of tests/test_serving_llm.py is a parity case here: the port's
ContinuousBatcher against JAX's on the same requests, greedy, with the
same tokens and ServeStats counters, and against the port's own B=1
scalar oracle. The sampled-mode tests run on the port alone, at the JAX
tests' bars."""

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
from prego_tpu.models.llama.model import forward as jax_forward
from prego_tpu.models.llama.model import init_cache as jax_init_cache
from prego_tpu.serving_llm import ContinuousBatcher as JaxBatcher
from prego_tpu.serving_llm import Request as JaxRequest
from prego_tpu_torch.checkpoint.bridge import llama_from_numpy
from prego_tpu_torch.models.llama import ByteTokenizer, Llama, LlamaConfig
from prego_tpu_torch.models.llama.model import forward, init_cache, precompute_rope
from prego_tpu_torch.serving_llm import ContinuousBatcher, Request
from tests.torch_parity import n, t

# f32 on both sides: logits differ by the summation order over 2 layers of
# width 64 (tests/test_torch_llama.py's bar for the scalar forward)
TOL = dict(rtol=1e-4, atol=1e-4)
# the int8 KV cache at decode: the port's plain K3 rounds q and p * v_scale
# to bf16 as the kernel does, the JAX CPU path dequantizes for an f32
# einsum; tests/test_torch_llama_quant.py's bar: RMS drift under 3% of the
# logits' spread, the same greedy token where JAX's top-2 margin passes a
# quarter of that spread
KV_RMS, KV_MARGIN = 0.03, 0.25
COUNTERS = ("decode_steps", "slot_steps_live", "slot_steps_total", "prefills", "prefix_hits",
            "prefix_tokens_reused", "suffix_tokens_prefilled", "suffix_tokens_piggybacked")


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


def _pair(seed, kv_quant=False, **kw):
    """JAX's Llama and the port's on the same f32 weights."""
    jcfg, tcfg = _configs(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed),
                                                  dtype=jnp.float32))
    return (JaxLlama(jp, JaxByteTokenizer(), jcfg, kv_quant=kv_quant),
            Llama(llama_from_numpy(jp), ByteTokenizer(), tcfg, kv_quant=kv_quant))


@pytest.fixture(scope="module")
def llama():
    return _pair(0)


@pytest.fixture(scope="module")
def llama_long():
    return _pair(2, max_seq_len=512)


def _oracle(tl, prompt, max_gen_len):
    """The port's B=1 scalar-path greedy decode (the reference semantics)."""
    cfg = tl.config
    rope = precompute_rope(cfg)
    cache = init_cache(cfg, 1, dtype=tl.dtype)
    with torch.no_grad():
        for i, tk in enumerate(prompt[:-1]):
            _, cache = forward(tl.params, torch.tensor([[tk]]), i, cache, cfg, rope)
        tok, out = prompt[-1], []
        for i in range(max_gen_len):
            logits, cache = forward(tl.params, torch.tensor([[tok]]), len(prompt) - 1 + i, cache,
                                    cfg, rope)
            tok = int(torch.argmax(logits[0, 0]))
            out.append(tok)
            if tok == tl.tokenizer.eos_id:
                break
    return out


def _serve_both(pair, reqs, register=None, same_tokens=True, **kw):
    """Serve ``reqs`` through JAX's batcher and the port's with the same
    arguments (and the same registered prefix): the same tokens for every
    request (unless ``same_tokens`` is off) and the same counters. Returns
    the port's (by_uid, stats, cb)."""
    jl, tl = pair
    kw = {"slots": 4, "chunk": 4, "temperature": 0.0, **kw}
    jcb, tcb = JaxBatcher(jl, **kw), ContinuousBatcher(tl, **kw)
    if register is not None:
        assert tcb.register_prefix(register) == jcb.register_prefix(register)
    jdone, jstats = jcb.serve([JaxRequest(r.uid, list(r.prompt), r.max_gen_len) for r in reqs])
    done, stats = tcb.serve([Request(r.uid, list(r.prompt), r.max_gen_len) for r in reqs])
    got = {c.uid: c.tokens for c in done}
    if same_tokens:
        assert got == {c.uid: c.tokens for c in jdone}
        assert [c.uid for c in done] == [c.uid for c in jdone]  # finish order
    assert {k: getattr(stats, k) for k in COUNTERS} == {k: getattr(jstats, k) for k in COUNTERS}
    return got, stats, tcb


def _random_requests(seed, n_req, max_prompt, max_gen, min_prompt=1, min_gen=1):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(4, 250, rng.integers(min_prompt, max_prompt)).tolist(),
                    max_gen_len=int(rng.integers(min_gen, max_gen))) for i in range(n_req)]


# ------------------------------------------------ per-row forward


@pytest.fixture(scope="module")
def per_row_weights():
    jcfg, tcfg = _configs(n_kv_heads=2, vocab_size=97, max_seq_len=32)
    jp = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0),
                                                  dtype=jnp.float32))
    return jcfg, tcfg, jp, llama_from_numpy(jp)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_per_row_forward_matches_jax(per_row_weights, kv_quant):
    """A per-row prefill (S = 4 at mixed positions), then per-row decode
    steps at mixed and at equal positions: logits and the written cache
    rows against JAX's per-row forward."""
    jcfg, tcfg, jp, tp = per_row_weights
    B = 3
    rng = np.random.default_rng(4)
    jc = jax_init_cache(jcfg, B, jnp.float32, quantized=kv_quant)
    tc = init_cache(tcfg, B, torch.float32, quantized=kv_quant)
    steps = [(rng.integers(0, 97, (B, 4)), [0, 3, 9])]  # S > 1, mixed
    steps += [(rng.integers(0, 97, (B, 1)), [4 + i, 7 + i, 13 + i]) for i in range(3)]
    steps += [(rng.integers(0, 97, (B, 1)), [17, 17, 17])]  # S = 1, equal
    for i, (toks, pos) in enumerate(steps):
        toks, pos = toks.astype(np.int32), np.asarray(pos, np.int32)
        jl, jc = jax_forward(jp, jnp.asarray(toks), jnp.asarray(pos), jc, jcfg)
        tl, tc = forward(tp, t(toks).long(), t(pos), tc, tcfg)
        want, got = np.asarray(jl), n(tl)
        if not kv_quant or i == 0:  # prefill: the same dequantized einsum
            np.testing.assert_allclose(got, want, **TOL)
            continue
        spread = np.std(want)
        assert np.sqrt(np.mean((got - want) ** 2)) / spread < KV_RMS
        srt = np.sort(want, axis=-1)
        clear = (srt[..., -1] - srt[..., -2]) / spread > KV_MARGIN
        assert np.all(got.argmax(-1)[clear] == want.argmax(-1)[clear])
    leaf_t, leaf_j = tc["k"][1], jc["k"][1]
    if kv_quant:  # K/V of the same f32 inputs: scales within an ulp
        leaf_t, leaf_j = leaf_t["s"], leaf_j["s"]
    np.testing.assert_allclose(n(leaf_t), np.asarray(leaf_j), **TOL)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("S", [1, 3])
def test_per_row_equal_entries_equal_scalar_bits(per_row_weights, kv_quant, S):
    """With every entry equal, the per-row path gives the scalar path's
    logits and cache bit for bit (the JAX docstring's promise)."""
    _, tcfg, _, tp = per_row_weights
    B = 3
    rng = np.random.default_rng(5)
    prefill = t(rng.integers(0, 97, (B, 6))).long()
    toks = t(rng.integers(0, 97, (B, S))).long()
    caches = []
    for start in (6, torch.full((B,), 6, dtype=torch.int32)):
        c = init_cache(tcfg, B, torch.float32, quantized=kv_quant)
        forward(tp, prefill, 0, c, tcfg)
        logits, c = forward(tp, toks, start, c, tcfg)
        caches.append((logits, c))
    (ls, cs), (lv, cv) = caches
    assert torch.equal(ls, lv)
    leaves = lambda c: [x for leaf in c["k"] + c["v"]
                        for x in (leaf.values() if isinstance(leaf, dict) else [leaf])]
    assert all(torch.equal(a, b) for a, b in zip(leaves(cs), leaves(cv)))


def test_per_row_decode_skips_k8_and_keeps_the_bound(per_row_weights, monkeypatch):
    """Per row, K8 and K8u are skipped (the JAX dispatch), K2 takes the
    (B,) bound start_pos + 1 as a device tensor."""
    from prego_tpu_torch.models.llama import model as model_mod

    _, tcfg, _, tp = per_row_weights
    seen = []
    real = model_mod.decode_attention
    monkeypatch.setattr(model_mod, "decode_attention",
                        lambda q, k, v, valid: seen.append(valid.clone()) or real(q, k, v, valid))
    for name in ("decode_attention_wo", "decode_attention_wo_res_upd"):
        monkeypatch.setattr(model_mod, name, lambda *a, **k: pytest.fail("K8 per row"))
    monkeypatch.setenv("PREGO_FUSED_CACHE_UPD", "1")
    c = init_cache(tcfg, 2, torch.float32)
    forward(tp, torch.tensor([[5], [6]]), torch.tensor([3, 8], dtype=torch.int32), c, tcfg)
    assert len(seen) == tcfg.n_layers
    assert all(v.dtype == torch.int32 and v.tolist() == [4, 9] for v in seen)


# ------------------------------------------------ the batcher


def test_single_request_matches_oracle(llama):
    req = Request(uid=0, prompt=[5, 9, 11, 30, 2], max_gen_len=12)
    got, stats, _ = _serve_both(llama, [req])
    assert got[0] == _oracle(llama[1], req.prompt, 12)
    assert stats.prefills == 1


def test_overlap_gate_short_bursts_decode_blocking(llama):
    """A one-chunk burst takes the blocking path even with overlap on; a
    long one keeps overlap and still matches the oracle."""
    req = Request(uid=0, prompt=[5, 9, 11, 30, 2], max_gen_len=4)
    got, stats, _ = _serve_both(llama, [req], overlap_fetch=True)
    assert stats.decode_steps == 4
    assert got[0] == _oracle(llama[1], req.prompt, 4)[:4]
    reqs = [Request(uid=i, prompt=[4 + i, 7, 21], max_gen_len=24) for i in range(12)]
    got, _, _ = _serve_both(llama, reqs, overlap_fetch=True)
    for r in reqs:
        assert got[r.uid] == _oracle(llama[1], r.prompt, 24), r.uid


def test_mixed_lengths_all_match_oracle(llama):
    reqs = _random_requests(3, 10, 40, 16)
    got, stats, _ = _serve_both(llama, reqs)
    assert sorted(got) == list(range(10))
    for r in reqs:
        assert got[r.uid] == _oracle(llama[1], r.prompt, r.max_gen_len), r.uid
    assert stats.prefills == 10


def test_outputs_independent_of_batch_composition(llama):
    req = Request(uid=99, prompt=[7, 40, 90], max_gen_len=10)
    crowd = _random_requests(5, 6, 30, 12, min_prompt=2, min_gen=2)
    alone, _, _ = _serve_both(llama, [req], chunk=2)
    crowded, _, _ = _serve_both(llama, crowd + [req], chunk=2)
    assert alone[99] == crowded[99]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_kv_quant_loop_matches_its_oracle(kv_quant):
    """The int8 KV slot cache: greedy output of the loop equals a B=1 slot
    loop with the same cache (and JAX's, tokens and counters)."""
    pair = _pair(1, kv_quant=kv_quant, max_batch_size=2)
    reqs = [Request(uid=0, prompt=[5, 9, 11], max_gen_len=8),
            Request(uid=1, prompt=[100, 200], max_gen_len=6),
            Request(uid=2, prompt=[30] * 20, max_gen_len=5)]
    got, _, _ = _serve_both(pair, reqs, slots=2)
    for r in reqs:
        solo, _ = ContinuousBatcher(pair[1], slots=1, chunk=4, temperature=0.0).serve([r])
        assert got[r.uid] == solo[0].tokens


def test_request_too_long_rejected(llama):
    with pytest.raises(ValueError):
        ContinuousBatcher(llama[1], slots=2).serve([Request(uid=0, prompt=[1] * 120,
                                                            max_gen_len=20)])


def test_utilization_stat(llama):
    reqs = [Request(uid=i, prompt=[5 + i, 9], max_gen_len=8) for i in range(4)]
    _, stats, _ = _serve_both(llama, reqs)
    assert 0.0 < stats.utilization <= 1.0
    assert stats.decode_steps >= 8


def test_prefix_sharing_admission_parity_and_accounting(llama_long):
    rng = np.random.default_rng(11)
    ctx = rng.integers(4, 250, 150).tolist()
    reqs = [Request(uid=i, prompt=ctx + rng.integers(4, 250, 5 + i).tolist(), max_gen_len=6)
            for i in range(6)]
    got, stats, cb = _serve_both(llama_long, reqs, register=ctx, slots=2)
    aligned = 128  # 150 floored to the 64-token grid
    assert (stats.prefills, stats.prefix_hits) == (6, 6)
    assert stats.prefix_tokens_reused == 6 * aligned
    assert stats.suffix_tokens_prefilled == sum(len(r.prompt) - 1 - aligned for r in reqs)
    for r in reqs:
        assert got[r.uid] == _oracle(llama_long[1], r.prompt, r.max_gen_len), r.uid


def test_prefix_sharing_off_matches_on(llama_long):
    ctx = np.random.default_rng(13).integers(4, 250, 100).tolist()
    reqs = [Request(uid=i, prompt=ctx + [10 + i, 20 + i], max_gen_len=5) for i in range(3)]
    on, stats_on, _ = _serve_both(llama_long, reqs, register=ctx, slots=2)
    off, stats_off, _ = _serve_both(llama_long, reqs, slots=2, prefix_sharing=False)
    assert stats_on.prefix_hits == 3 and stats_off.prefix_hits == 0
    assert on == off


def test_long_suffix_admission_does_not_clobber_prefix():
    """A suffix whose bucket would overrun max_seq_len (max_seq_len 256,
    prefix 64, 130-token tails) is cut to the window."""
    pair = _pair(7, max_batch_size=2, max_seq_len=256)
    rng = np.random.default_rng(19)
    ctx = rng.integers(4, 250, 70).tolist()
    reqs = [Request(uid=i, prompt=ctx[:64] + rng.integers(4, 250, 130).tolist(), max_gen_len=8)
            for i in range(3)]  # one row alone, then two sharing
    got, stats, _ = _serve_both(pair, reqs, register=ctx, slots=2)
    assert stats.prefix_hits == 3
    for r in reqs:
        assert got[r.uid] == _oracle(pair[1], r.prompt, r.max_gen_len), r.uid


def test_cache_reuse_across_serve_calls(llama):
    """The batcher keeps its slot cache between serve() calls; stale rows
    never leak into a later request."""
    jl, tl = llama
    jcb = JaxBatcher(jl, slots=2, chunk=4, temperature=0.0)
    tcb = ContinuousBatcher(tl, slots=2, chunk=4, temperature=0.0)
    jcb.serve([JaxRequest(uid=0, prompt=[40] * 30, max_gen_len=6)])
    tcb.serve([Request(uid=0, prompt=[40] * 30, max_gen_len=6)])
    cache = tcb._cache
    req = Request(uid=1, prompt=[5, 9, 11], max_gen_len=8)
    done, _ = tcb.serve([req])
    jdone, _ = jcb.serve([JaxRequest(uid=1, prompt=[5, 9, 11], max_gen_len=8)])
    assert tcb._cache is cache  # the same tensors, written in place
    assert done[0].tokens == jdone[0].tokens == _oracle(tl, req.prompt, 8)


def test_prefix_reuse_across_serve_calls(llama_long):
    """A prefix registered once serves later calls from the LRU (and the
    LRU entry is never written by an admission)."""
    jl, tl = llama_long
    ctx = np.random.default_rng(23).integers(4, 250, 130).tolist()
    cb = ContinuousBatcher(tl, slots=2, chunk=4, temperature=0.0)
    cb.register_prefix(ctx)
    entry = tl._prefix_caches[tuple(ctx[:128])]
    before = [x.clone() for x in entry["k"] + entry["v"]]
    for call in range(2):
        reqs = [Request(uid=i, prompt=ctx + [30 + call, 40 + i, 7], max_gen_len=5)
                for i in range(3)]
        done, stats = cb.serve(reqs)
        assert stats.prefix_hits == 3
        for c in done:
            r = reqs[c.uid]
            assert c.tokens == _oracle(tl, r.prompt, r.max_gen_len)
    assert all(torch.equal(a, b) for a, b in zip(before, entry["k"] + entry["v"]))


def test_serve_prompts_order_and_greedy_parity(llama_long):
    jl, tl = llama_long
    ctx = np.random.default_rng(17).integers(4, 250, 90).tolist()
    prompts = [ctx + [30 + i] for i in range(5)]
    got = ContinuousBatcher(tl, slots=4, chunk=4, temperature=0.0).serve_prompts(prompts, 6)
    want = JaxBatcher(jl, slots=4, chunk=4, temperature=0.0).serve_prompts(prompts, 6)
    assert got == want == tl.generate(prompts, max_gen_len=6, temperature=0.0)[0]


def test_overlap_fetch_matches_blocking(llama):
    reqs = _random_requests(41, 10, 40, 16)
    a, stats_a, _ = _serve_both(llama, reqs, slots=3)
    b, stats_b, _ = _serve_both(llama, reqs, slots=3, overlap_fetch=True)
    assert a == b
    assert stats_a.slot_steps_live == stats_b.slot_steps_live


def test_overlap_fetch_default_is_platform_aware(llama, monkeypatch):
    tl = llama[1]
    monkeypatch.delenv("PREGO_CB_OVERLAP", raising=False)
    assert ContinuousBatcher(tl, slots=2).overlap_fetch is False  # CPU
    monkeypatch.setenv("PREGO_CB_OVERLAP", "1")
    assert ContinuousBatcher(tl, slots=2).overlap_fetch is True
    monkeypatch.setenv("PREGO_CB_OVERLAP", "0")
    assert ContinuousBatcher(tl, slots=2).overlap_fetch is False
    assert ContinuousBatcher(tl, slots=2, overlap_fetch=True).overlap_fetch is True


def test_prefix_sharing_with_kv_quant_batched_admission():
    """int8 KV cache + prefix sharing + multi-slot admission: the port's
    own B=1 slot loop is the token bar, as in the JAX test (the int8 KV
    decode logits differ from JAX's within KV_RMS, enough to move a greedy
    token at a near-tie); JAX's counters are equal."""
    pair = _pair(5, kv_quant=True, max_seq_len=512)
    rng = np.random.default_rng(3)
    ctx = rng.integers(4, 250, 150).tolist()
    reqs = [Request(uid=i, prompt=ctx + rng.integers(4, 250, 5 + i).tolist(), max_gen_len=6)
            for i in range(6)]
    got, stats, _ = _serve_both(pair, reqs, register=ctx, same_tokens=False)
    assert stats.prefix_hits == 6
    for r in reqs:
        solo, _ = ContinuousBatcher(pair[1], slots=1, chunk=4, temperature=0.0).serve([r])
        assert got[r.uid] == solo[0].tokens, r.uid


def test_piggyback_on_off_parity_and_accounting(llama_long):
    rng = np.random.default_rng(43)
    ctx = rng.integers(4, 250, 128).tolist()
    reqs = [Request(uid=i, prompt=ctx + rng.integers(4, 250, 4 + 3 * i).tolist(), max_gen_len=6)
            for i in range(5)]
    p, stats_p, _ = _serve_both(llama_long, reqs, register=ctx, slots=2,
                                piggyback_max_suffix=8)
    d, stats_d, _ = _serve_both(llama_long, reqs, register=ctx, slots=2,
                                piggyback_max_suffix=0)
    assert p == d
    assert stats_p.suffix_tokens_piggybacked == 3 + 6
    assert stats_p.suffix_tokens_prefilled == 9 + 12 + 15
    assert stats_d.suffix_tokens_piggybacked == 0
    assert (stats_p.suffix_tokens_piggybacked + stats_p.suffix_tokens_prefilled
            == stats_d.suffix_tokens_prefilled)
    assert stats_p.prefix_hits == stats_d.prefix_hits == 5
    for r in reqs:
        assert p[r.uid] == _oracle(llama_long[1], r.prompt, r.max_gen_len), r.uid


def test_piggyback_env_override(llama, monkeypatch):
    tl = llama[1]
    monkeypatch.setenv("PREGO_CB_PIGGYBACK", "0")
    assert ContinuousBatcher(tl, slots=4).pend_buf == 1  # the last-token feed always queues
    monkeypatch.setenv("PREGO_CB_PIGGYBACK", "23")
    assert ContinuousBatcher(tl, slots=4).pend_buf == 23
    monkeypatch.delenv("PREGO_CB_PIGGYBACK")
    assert ContinuousBatcher(tl, slots=4).pend_buf == 4
    assert ContinuousBatcher(tl, slots=4, piggyback_max_suffix=7).pend_buf == 7


def test_piggyback_without_prefix_matches_oracle(llama):
    reqs = _random_requests(47, 7, 15, 10)
    got, stats, _ = _serve_both(llama, reqs, slots=3, piggyback_max_suffix=16)
    assert stats.suffix_tokens_prefilled == 0  # everything piggybacked
    for r in reqs:
        assert got[r.uid] == _oracle(llama[1], r.prompt, r.max_gen_len)


def test_sampled_mode_matches_per_request_distribution(llama):
    """temperature > 0 through the slot loop draws from the per-step
    distributions of per-request generation: the total-variation distance
    of the first tokens over 600 seeded draws each stays under 0.2."""
    tl = llama[1]
    prompt, N, temperature, top_p = [5, 9, 11], 600, 0.25, 0.9
    cb = ContinuousBatcher(tl, slots=4, chunk=2, temperature=temperature, top_p=top_p, seed=23)
    done, _ = cb.serve([Request(uid=i, prompt=list(prompt), max_gen_len=1) for i in range(N)])
    eos = tl.tokenizer.eos_id
    cb_first = [c.tokens[0] for c in done]
    outs, _ = tl.generate([list(prompt)] * N, max_gen_len=1, temperature=temperature,
                          top_p=top_p)
    gen_first = [o[0] if o else eos for o in outs]  # generate cuts AT eos
    support = sorted(set(cb_first) | set(gen_first))
    assert len(support) > 1, "degenerate distribution: the test is vacuous"
    pa, pb = collections.Counter(cb_first), collections.Counter(gen_first)
    tv = 0.5 * sum(abs(pa[x] - pb[x]) / N for x in support)
    assert tv < 0.2, (tv, pa.most_common(5), pb.most_common(5))


def test_sampled_mode_budgets_and_retirement(llama):
    tl = llama[1]
    reqs = _random_requests(29, 8, 20, 10, min_prompt=2)
    done, _ = ContinuousBatcher(tl, slots=3, chunk=4, temperature=0.9, top_p=0.9).serve(reqs)
    assert sorted(c.uid for c in done) == list(range(8))
    for c in done:
        budget = reqs[c.uid].max_gen_len
        assert len(c.tokens) <= budget
        if len(c.tokens) < budget:
            assert c.tokens[-1] == tl.tokenizer.eos_id


def test_sampler_seed_from_env(llama, monkeypatch):
    """PREGO_SAMPLE_SEED seeds the batcher's generator (default seed=1)."""
    tl = llama[1]
    reqs = [Request(uid=i, prompt=[5, 9, 11], max_gen_len=6) for i in range(4)]
    runs = {}
    for env in ("7", "7", "8"):
        monkeypatch.setenv("PREGO_SAMPLE_SEED", env)
        done, _ = ContinuousBatcher(tl, slots=4, chunk=4, temperature=1.0, seed=3).serve(reqs)
        runs.setdefault(env, []).append({c.uid: c.tokens for c in done})
    assert runs["7"][0] == runs["7"][1]
    assert runs["7"][0] != runs["8"][0]


def test_without_a_card_the_adapter_raises_unless_cpu(monkeypatch):
    """TorchLlamaLLM(serving="cb") defaults to the card and raises without
    one; an unknown serving mode is refused."""
    from prego_tpu_torch.anticipation.llm import TorchLlamaLLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchLlamaLLM(fabricated="tiny", serving="cb")
    with pytest.raises(ValueError, match="serving"):
        TorchLlamaLLM(fabricated="tiny", serving="stream", device="cpu")
    llm = TorchLlamaLLM(fabricated="tiny", serving="cb", cb_slots=3, device="cpu",
                        max_seq_len=256)
    out = llm.text_completion(["Input Sequence:\n 3, 1\nOutput:\n"] * 2, max_gen_len=4,
                              temperature=0.0)
    assert len(out) == 2 and llm._batcher().slots == 3
    assert out[0] == out[1]  # the same prompt, greedy
