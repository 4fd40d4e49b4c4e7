"""Speculative decoding: draft-proposed, target-verified generation (port
of prego_tpu/models/llama/speculative.py).

A cheap draft model proposes ``k`` tokens a round; the target checks all
of them in one (B, k+1) forward at per-row positions, and each row keeps
the prefix of drafts the target agrees with plus one token of the
target's own, so a round emits 1 to k+1 tokens a row for one target
forward. The design is the JAX package's:

* **No rollback.** Attention is masked by absolute position and every
  round rewrites the cache window [pos, pos+k] before a query can attend
  it, so keys of rejected drafts are never read: a row "rolls back" by not
  advancing its position.
* **Bonus token.** The verify feeds the current token and all k drafts,
  so it yields k+1 target distributions: the k checks and the token after
  the last draft, emitted when every draft is accepted.
* **Per row.** Each row accepts its own number of drafts a round and
  decodes at its own offset, through ``model.forward``'s (B,) start_pos
  (K2 and K3 bounded per row, K8 and K8u skipped, as in the JAX package).
* **A spare cache tail** (``_cache_spare``): while any row is active the
  verify runs for every row, including rows frozen at the window edge;
  their writes land past max_seq_len instead of being clamped back over
  real keys.

Greedy verification accepts a draft iff it equals the target's argmax, so
greedy speculative output equals plain greedy decoding for any draft.
Sampled mode applies the Leviathan/Chen rule (accept x ~ q with
probability min(1, p(x)/q(x)), else resample from norm(max(p - q, 0)))
to the processed distributions (``ops/sampling.py::processed_probs``),
which preserves the target's sampling distribution.

Where the JAX package runs the rounds in one jitted ``while_loop``, the
port runs a host loop of rounds whose state (positions, current tokens,
the output buffer, counts, eos flags) stays on the device. The host reads
one flag a round, whether any row is still active, and the counts once a
``generate``; ``host_reads`` and ``read_wait_s`` record what those reads
cost.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from prego_tpu_torch.core.seed import make_generator
from prego_tpu_torch.models.llama.config import LlamaConfig, refuse_latent
from prego_tpu_torch.models.llama.generation import Llama, cut_row, round_up, split_batch
from prego_tpu_torch.models.llama.model import Cache, Params, forward, load_rows
from prego_tpu_torch.ops.sampling import categorical, processed_probs


def _cache_spare(config: LlamaConfig, k: int) -> int:
    """Positions past max_seq_len on the speculative caches' T axis: 256
    where max_seq_len is a multiple of 256 (the JAX package keeps its
    decode kernels' T blocks whole), else the k + 1 a verify writes."""
    return 256 if config.max_seq_len % 256 == 0 else k + 1


class _Spec:
    """The fixed parts of one speculative ``generate``: both models, the
    round's sizes and the sampler."""

    def __init__(self, target, draft, oracle, k, out_buf_len, temperature, top_p, generator):
        self.t_params, self.cfg, self.t_rope = target.params, target.config, target.rope
        self.draft = draft  # the draft's Llama, None with an oracle
        self.oracle = oracle  # (B, max_seq_len + k) replay, or None
        self.k, self.out_buf_len = k, out_buf_len
        self.temperature, self.top_p = temperature, top_p
        self.generator = generator

    def pick(self, logits: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The next token of each row from (B, V) logits, and in sampled
        mode the processed distribution it was drawn from."""
        if self.temperature > 0:
            p = processed_probs(logits, self.temperature, self.top_p)
            return categorical(p, self.generator), p
        return torch.argmax(logits, dim=-1), None

    def drafts(self, cur_tok, pos, d_cache):
        """(B, k) proposals for pos+1 .. pos+k and, sampled, their (B, k, V)
        distributions. k+1 single-token draft forwards: the last proposal
        is discarded, but its forward writes the draft key at pos+k that a
        fully accepted round needs (pos then advances by k+1, and without
        that key the next round's draft attends garbage and acceptance
        collapses)."""
        k = self.k
        if self.oracle is not None:
            idx = pos.long()[:, None] + 1 + torch.arange(k, device=pos.device)[None, :]
            return torch.gather(self.oracle, 1, idx), None
        d = self.draft
        tok, toks, qs = cur_tok, [], []
        for i in range(k + 1):
            logits, _ = forward(d.params, tok[:, None], pos + i, d_cache, d.config, d.rope)
            if i == k:
                break
            tok, q = self.pick(logits[:, 0])
            toks.append(tok)
            qs.append(q)
        return torch.stack(toks, dim=1), (torch.stack(qs, dim=1) if qs[0] is not None else None)

    def accept(self, t_logits, drafts, q_dists):
        """Accepted drafts a (B,) in 0..k and the token after them (B,)."""
        k = self.k
        B = drafts.shape[0]
        rows = torch.arange(B, device=drafts.device)
        if self.temperature > 0:
            V = t_logits.shape[-1]
            p = processed_probs(t_logits.reshape(B * (k + 1), V), self.temperature,
                                self.top_p).reshape(B, k + 1, V)
            pd = torch.gather(p[:, :k], -1, drafts[..., None])[..., 0]
            qd = torch.gather(q_dists, -1, drafts[..., None])[..., 0]
            u = torch.rand((B, k), generator=self.generator, device=drafts.device)
            acc = u * qd <= pd  # accept w.p. min(1, p/q), without a division
            a = torch.cumprod(acc.long(), dim=1).sum(dim=1)
            # the correction at index a from norm(max(p - q, 0)); at a == k no
            # draft was made, q is 0 there and the bonus comes straight from p
            q_pad = torch.cat([q_dists, torch.zeros_like(q_dists[:, :1])], dim=1)
            p_ra = p[rows, a]
            resid = torch.clamp(p_ra - q_pad[rows, a], min=0.0)
            rs = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(rs > 1e-9, resid / torch.clamp(rs, min=1e-30), p_ra)
            return a, categorical(resid, self.generator)
        t_hat = torch.argmax(t_logits, dim=-1)  # (B, k+1)
        a = torch.cumprod((drafts == t_hat[:, :k]).long(), dim=1).sum(dim=1)
        return a, t_hat[rows, a]  # the bonus token where a == k


class SpeculativeLlama:
    """Speculative wrapper around a target :class:`Llama`.

    ``draft_params``/``draft_config`` select the proposal model (the
    target's vocabulary, a ``max_seq_len`` at least the target's); a
    ``self_draft`` tree shares the target's tensors. ``generate(...,
    oracle_tokens=...)`` replays known continuations as the draft instead
    (no draft cost: the acceptance-1 measurement). Rows decode at their own
    positions; ``rounds``, ``drafts_accepted`` and ``drafts_proposed`` (k
    per active row a round) add up over calls."""

    def __init__(
        self,
        target,  # Llama (generation.py)
        draft_params: Optional[Params] = None,
        draft_config: Optional[LlamaConfig] = None,
        k: int = 4,
        pad_to_multiple: int = 64,
    ):
        refuse_latent(target.config, "speculative decoding (spec_k)")
        if draft_config is not None:
            if draft_config.vocab_size != target.config.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if draft_config.max_seq_len < target.config.max_seq_len:
                raise ValueError("the draft cache must cover the target sequence length")
        self.target = target
        self.draft_params = draft_params
        self.draft_config = draft_config
        # a self-draft (``self_draft``) holds the target's own tensors
        self._self_draft_layers = 0
        tp = target.params
        if (
            draft_params is not None
            and all(draft_params[n] is tp[n] for n in ("tok_embeddings", "norm", "output"))
            and len(draft_params["layers"]) <= len(tp["layers"])
            and all(d is t for d, t in zip(draft_params["layers"], tp["layers"]))
        ):
            self._self_draft_layers = len(draft_params["layers"])
        self.k = int(k)
        self.pad_to_multiple = pad_to_multiple
        self.generator = make_generator(int(os.environ.get("PREGO_SAMPLE_SEED", "1")),
                                        target.device)
        # the draft reuses Llama's prefix LRU for its own caches, which
        # follow the target's KV quantization
        self._draft_llama = None
        if draft_params is not None:
            self._draft_llama = Llama(
                draft_params, target.tokenizer, draft_config,
                prefix_cache_slots=target.prefix_cache_slots, kv_quant=target.kv_quant,
            )
        self.rounds = 0
        self.drafts_accepted = 0
        self.drafts_proposed = 0  # k per active row a round
        self.host_reads = 0  # the loop's one-flag reads
        self.read_wait_s = 0.0  # host time spent waiting on them

    def _any(self, flags: torch.Tensor) -> bool:
        """Whether any entry of ``flags`` is set: the loop's one read."""
        t0 = time.perf_counter()
        out = bool(flags.any())
        self.read_wait_s += time.perf_counter() - t0
        self.host_reads += 1
        return out

    @torch.no_grad()
    def _run(
        self,
        spec: _Spec,
        prompt: torch.Tensor,  # (B, Pbuf) int64, pad-filled, suffix coords
        prompt_len: torch.Tensor,  # (B,) int64 >= 1
        out_budget: int,
        t_cache: Cache,
        d_cache: Optional[Cache],
        start_offset: int,  # absolute position of prompt[:, 0]
        eos_id: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill both caches, run the rounds, then the plain tail; returns
        (out_buf (B, out_buf_len), n_emitted (B,)) on the device and adds
        the round counts to the wrapper's."""
        cfg, k, L = spec.cfg, spec.k, spec.out_buf_len
        B = prompt.shape[0]
        dev = prompt.device
        # cache-only prefill: the first verify re-feeds each row's last
        # prompt token; the pad tail past a row's prompt is rewritten by
        # its rounds before any query attends it
        forward(spec.t_params, prompt, start_offset, t_cache, cfg, spec.t_rope)
        if spec.oracle is None:
            d = spec.draft
            forward(d.params, prompt, start_offset, d_cache, d.config, d.rope)
        rows = torch.arange(B, device=dev)
        ar = torch.arange(k + 1, device=dev)
        pos = (start_offset + prompt_len - 1).to(torch.int32)
        cur_tok = prompt[rows, prompt_len - 1]
        out_buf = torch.zeros((B, L), dtype=torch.int64, device=dev)
        n_emitted = torch.zeros(B, dtype=torch.int64, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        proposed = torch.zeros((), dtype=torch.int64, device=dev)
        rounds = 0
        while True:
            # rows whose verify would pass the window stop here; the plain
            # tail below finishes them
            active = ~done & (n_emitted < out_budget) & (pos + k + 1 <= cfg.max_seq_len)
            if not self._any(active):
                break
            drafts, q_dists = spec.drafts(cur_tok, pos, d_cache)
            fed = torch.cat([cur_tok[:, None], drafts], dim=1)
            t_logits, _ = forward(spec.t_params, fed, pos, t_cache, cfg, spec.t_rope)
            a, corr = spec.accept(t_logits, drafts, q_dists)
            n_new = a + 1
            drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            emit = torch.where(ar[None] < a[:, None], drafts_pad, corr[:, None])
            # eos inside the round: each row keeps up to its first eos
            hit = (emit == eos_id) & (ar[None] < n_new[:, None])
            eos_at = torch.where(hit, ar[None], k + 1).min(dim=1).values
            got_eos = eos_at < k + 1
            n_new = torch.where(got_eos, eos_at + 1, n_new)
            n_new = torch.where(active, n_new, 0)
            # rows that emit nothing write past their final cut, never read
            out_buf.scatter_(1, torch.clamp(n_emitted, max=L - k - 1)[:, None] + ar[None], emit)
            cur_tok = torch.where(active, emit[rows, torch.clamp(n_new - 1, min=0)], cur_tok)
            pos = pos + n_new.to(torch.int32)
            n_emitted = n_emitted + n_new
            done = done | (got_eos & active)
            rounds += 1
            accepted += torch.where(active, a, 0).sum()
            proposed += k * active.sum()
        # the plain single-token tail for rows frozen at the window edge (up
        # to k tokens short), so that output equals plain decoding there too
        while True:
            active = ~done & (n_emitted < out_budget)
            if not self._any(active):
                break
            logits, _ = forward(spec.t_params, cur_tok[:, None], pos, t_cache, cfg, spec.t_rope)
            nxt, _ = spec.pick(logits[:, 0])
            out_buf.scatter_(1, torch.clamp(n_emitted, max=L - 1)[:, None], nxt[:, None])
            n_emitted = n_emitted + active
            pos = pos + active.to(torch.int32)
            done = done | (active & (nxt == eos_id))
            cur_tok = torch.where(active, nxt, cur_tok)
        counts = torch.stack([accepted, proposed]).cpu()  # one read a generate
        self.rounds += rounds
        self.drafts_accepted += int(counts[0])
        self.drafts_proposed += int(counts[1])
        return out_buf, n_emitted

    def _cut(self, out_buf, n_emitted, max_gen_len) -> List[List[int]]:
        """The host cut of ``Llama.generate``: the budget, then pad, then eos."""
        tok = self.target.tokenizer
        return [cut_row(row[: min(int(n), max_gen_len)], tok.pad_id, tok.eos_id)[0]
                for row, n in zip(out_buf.cpu().tolist(), n_emitted.cpu().tolist())]

    def _rows(self, llama: Llama, batch: int, prefix: Optional[Cache] = None) -> Cache:
        """A call's cache of ``llama``'s kind, ``batch`` rows and max_seq_len
        + ``_cache_spare`` positions, loaded with its B=1 prefix entry, or
        zeroes. Past the call's prefix the entry holds the pad K/V of its
        last build chunk, or zeros: the suffix prefill, then each verify,
        writes a position before any query attends it."""
        spare = _cache_spare(llama.config, self.k)
        return load_rows(llama._new_cache(batch, spare), batch, llama.config.max_seq_len + spare,
                         prefix)

    def _spec(self, oracle, out_buf_len, temperature, top_p) -> _Spec:
        return _Spec(self.target, self._draft_llama if oracle is None else None, oracle,
                     self.k, out_buf_len, float(temperature), float(top_p), self.generator)

    def generate(
        self,
        prompt_tokens: List[List[int]],
        max_gen_len: int,
        temperature: float = 0.0,
        top_p: float = 0.9,
        oracle_tokens: Optional[List[List[int]]] = None,
    ) -> List[List[int]]:
        """Generated (non-echo) tokens per prompt. ``oracle_tokens``
        (absolute-position replays, prompt included, one per row) needs
        temperature 0 and takes the place of the draft."""
        target, cfg = self.target, self.target.config
        tok = target.tokenizer
        if oracle_tokens is None:
            if self.draft_params is None:
                raise ValueError("SpeculativeLlama needs draft_params or oracle_tokens")
        else:
            if temperature != 0.0:
                raise ValueError("oracle replay is greedy-only")
            if len(oracle_tokens) != len(prompt_tokens):
                raise ValueError("one oracle replay a prompt")
        parts = split_batch(prompt_tokens, cfg.max_batch_size)
        if len(parts) > 1:
            oracles = ([None] * len(parts) if oracle_tokens is None
                       else split_batch(oracle_tokens, cfg.max_batch_size))
            return [t for p, o in zip(parts, oracles)
                    for t in self.generate(p, max_gen_len, temperature, top_p, o)]
        bsz = len(prompt_tokens)
        max_p = max(len(t) for t in prompt_tokens)
        if not 1 <= max_p <= cfg.max_seq_len:
            raise ValueError(f"prompt of {max_p} tokens outside [1, max_seq_len]")
        max_gen_len = min(max_gen_len, cfg.max_seq_len - max_p)
        p_buf = min(round_up(max_p, self.pad_to_multiple), cfg.max_seq_len)
        buf = np.full((bsz, p_buf), tok.pad_id, np.int64)
        for i, t in enumerate(prompt_tokens):
            buf[i, : len(t)] = t
        out_buf_len = round_up(max_gen_len + self.k + 1, self.pad_to_multiple)
        dev = target.device
        oracle = None
        if oracle_tokens is not None:
            o = np.full((bsz, cfg.max_seq_len + self.k), tok.pad_id, np.int64)
            for i, t in enumerate(oracle_tokens):
                o[i, : len(t)] = t
            oracle = torch.from_numpy(o).to(dev)
        spec = self._spec(oracle, out_buf_len, temperature, top_p)
        t_cache = self._rows(target, bsz)
        d_cache = None if oracle is not None else self._rows(self._draft_llama, bsz)
        out, n = self._run(
            spec, torch.from_numpy(buf).to(dev),
            torch.tensor([len(t) for t in prompt_tokens], dtype=torch.int64, device=dev),
            max_gen_len, t_cache, d_cache, 0, int(tok.eos_id))
        return self._cut(out, n, max_gen_len)

    def generate_with_prefix_cache(
        self,
        prompt_tokens: List[List[int]],
        max_gen_len: int,
        temperature: float = 0.0,
        top_p: float = 0.9,
    ) -> List[List[int]]:
        """Speculative generation that reuses both models' KV of the
        batch-common prompt prefix, as ``Llama.generate_with_prefix_cache``
        finds it: the target's LRU is the one the plain path uses, the
        draft keeps its own; both resume from their B=1 prefix caches and
        prefill only the suffixes."""
        target, cfg = self.target, self.target.config
        if self._draft_llama is None:
            raise ValueError("prefix-cached speculation needs a draft model")
        parts = split_batch(prompt_tokens, cfg.max_batch_size)
        if len(parts) > 1:
            return [t for p in parts
                    for t in self.generate_with_prefix_cache(p, max_gen_len, temperature, top_p)]
        if max(len(t) for t in prompt_tokens) > cfg.max_seq_len:
            raise ValueError("prompt exceeds max_seq_len")
        eff = target.shared_prefix(prompt_tokens)
        if not eff:
            return self.generate(prompt_tokens, max_gen_len, temperature, top_p)

        prefix = tuple(prompt_tokens[0][:eff])
        t_prefix = target.ensure_prefix(prefix)
        d_prefix = self._draft_llama.ensure_prefix(prefix)
        bsz = len(prompt_tokens)
        tok = target.tokenizer
        suffixes = [t[eff:] for t in prompt_tokens]
        max_s = max(len(s) for s in suffixes)
        max_gen_len = min(max_gen_len, cfg.max_seq_len - eff - max_s)
        s_buf = min(round_up(max_s, self.pad_to_multiple), cfg.max_seq_len - eff)
        buf = np.full((bsz, s_buf), tok.pad_id, np.int64)
        for i, s in enumerate(suffixes):
            buf[i, : len(s)] = s
        out_buf_len = round_up(max_gen_len + self.k + 1, self.pad_to_multiple)
        dev = target.device
        spec = self._spec(None, out_buf_len, temperature, top_p)
        t_cache = self._rows(target, bsz, t_prefix)
        d_cache = self._rows(self._draft_llama, bsz, d_prefix)
        out, n = self._run(
            spec, torch.from_numpy(buf).to(dev),
            torch.tensor([len(s) for s in suffixes], dtype=torch.int64, device=dev),
            max_gen_len, t_cache, d_cache, eff, int(tok.eos_id))
        return self._cut(out, n, max_gen_len)

    def text_completion(
        self,
        prompts: List[str],
        temperature: float = 0.0,
        top_p: float = 0.9,
        max_gen_len: Optional[int] = None,
        use_prefix_cache: bool = False,
    ) -> List[dict]:
        if max_gen_len is None:
            max_gen_len = self.target.config.max_seq_len - 1
        tok = self.target.tokenizer
        prompt_tokens = [tok.encode(x, bos=True, eos=False) for x in prompts]
        gen = (self.generate_with_prefix_cache
               if use_prefix_cache and self._draft_llama is not None else self.generate)
        gens = gen(prompt_tokens, max_gen_len=max_gen_len, temperature=temperature, top_p=top_p)
        return [{"generation": tok.decode(g)} for g in gens]


def self_draft(
    target_params: Params, config: LlamaConfig, n_layers: int
) -> Tuple[Params, LlamaConfig]:
    """The target's own first ``n_layers`` blocks, with its embedding, final
    norm and lm-head, as the draft (the LayerSkip / Draft-&-Verify
    early-exit family). The tree holds the target's tensors: no weight is
    copied, for every layout (bf16, int8 {"q", "s"}, fused or not). With
    random weights acceptance is ~0 like any independent draft;
    ``n_layers`` equal to the target's depth makes the draft the target."""
    if not 1 <= n_layers <= config.n_layers:
        raise ValueError(f"self-draft depth {n_layers} outside [1, {config.n_layers}]")
    d_params = dict(target_params)
    d_params["layers"] = list(target_params["layers"])[:n_layers]
    return d_params, dataclasses.replace(config, n_layers=n_layers)
