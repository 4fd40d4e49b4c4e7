"""Continuous-batching LLM serving loop (port of prego_tpu/serving_llm.py).

The reference serves LLaMA with static request batches
(step_anticipation/llama/generation.py:121-215): a batch is padded to the
longest prompt, decodes in lockstep, and new work waits for the whole
batch to drain. This module runs one decode loop over S cache slots and
lets requests enter and leave mid-flight:

  - the KV cache is one S-row cache that the batcher owns and reuses
    across ``serve`` calls, written in place; each slot carries its own
    write position, and ``model.forward``'s per-row ``start_pos`` writes
    each row at its offset and bounds its attention (K2 and K3 take (B,)
    bounds; K8 and K8u are skipped per row, as in the JAX package);
  - admission shares prefixes: when a prompt starts with a prefix held in
    the Llama's KV-prefix LRU (the PREGO workload sends the same few-shot
    context with many requests), the cached B=1 prefix KV is repeated to
    the admitted rows, only the per-request suffixes are prefilled (one
    forward for the requests that share a prefix, the suffix length
    bucketed), and each row is written into its slot with ``index_copy_``;
  - decode runs ``chunk`` per-row forwards between admission points over
    slot state that stays on the device (token, position, liveness,
    budget, pending prompt tokens); finished slots (eos or the request's
    budget) retire and free their row without stalling the live ones;
  - the host reads the device once per chunk (the emitted-token block)
    and mirrors slot liveness and budgets from the emissions, so no slot
    state comes back to the host. With the overlap fetch that block is
    copied into pinned host memory behind a CUDA event, and the host
    handles chunk N-1 while the card runs chunk N;
  - short suffixes ride the decode loop itself (piggyback admission): the
    admitted row feeds its pending prompt tokens one per decode step,
    sharing the weight stream that the step already pays, and admission
    costs only the prefix-KV row copy. Only suffixes of at most
    ``PREGO_CB_PIGGYBACK`` tokens (default 4; 0 disables) ride: a
    piggybacked suffix holds its slot one step a token without emitting.

Where the JAX package jits a ``lax.scan`` of the chunk and donates the
cache, the port runs a Python loop of per-row forwards over the
batcher's own cache; capturing that loop as a CUDA graph is later work
(ROADMAP). Greedy output at temperature 0 equals per-request generation;
sampled output draws from the batcher's own ``torch.Generator``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from prego_tpu_torch.core.seed import make_generator
from prego_tpu_torch.models.llama.config import LlamaConfig, refuse_latent
from prego_tpu_torch.models.llama.generation import cut_row
from prego_tpu_torch.models.llama.model import Cache, Params, clone_cache, forward, init_cache
from prego_tpu_torch.ops.sampling import sample_next_token

PAD_EMIT = -1  # emitted for dead rows; never a real token id


@dataclass
class Request:
    uid: int
    prompt: List[int]  # token ids, len >= 1
    max_gen_len: int


@dataclass
class Completion:
    uid: int
    tokens: List[int]  # generated ids (eos included when hit)
    prompt_len: int
    admitted_step: int  # global decode-step index at admission
    finished_step: int
    wall_latency_s: float  # admission -> finish
    finished_wall_s: float  # serve() start -> finish (burst latency)


@dataclass
class ServeStats:
    decode_steps: int = 0
    slot_steps_live: int = 0  # sum over steps of live slots
    slot_steps_total: int = 0  # decode_steps * slots
    prefills: int = 0  # admissions
    prefix_hits: int = 0  # admissions that reused a cached KV prefix
    prefix_tokens_reused: int = 0  # prompt tokens NOT re-prefilled
    suffix_tokens_prefilled: int = 0  # prompt tokens through a dedicated prefill
    suffix_tokens_piggybacked: int = 0  # prompt tokens fed through the decode loop
    wall_s: float = 0.0

    @property
    def utilization(self) -> float:
        return self.slot_steps_live / max(self.slot_steps_total, 1)

    def add(self, other: "ServeStats") -> None:
        """Adds ``other``'s counts and wall time to this one's."""
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory, so
    that the host does not wait for the work already queued there."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def _leaves(cache: Cache) -> List[torch.Tensor]:
    """The cache's tensors in a fixed order (an int8 leaf gives q, then s)."""
    out = []
    for key in ("k", "v"):
        for leaf in cache[key]:
            out.extend([leaf["q"], leaf["s"]] if isinstance(leaf, dict) else [leaf])
    return out


def _zero_rows(big: Cache, rows: int) -> Cache:
    """A zero cache shaped like ``big`` with ``rows`` rows."""
    def zeros(leaf):
        if isinstance(leaf, dict):
            return {k: zeros(v) for k, v in leaf.items()}
        return torch.zeros((rows,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)

    return {key: [zeros(leaf) for leaf in big[key]] for key in ("k", "v")}


def _insert_row(big: Cache, small: Cache, slots: torch.Tensor) -> None:
    """Write the rows of ``small`` into rows ``slots`` ((K,) int64 on the
    device) of the batched cache, in place; a B=1 ``small`` goes to every
    slot."""
    K = slots.shape[0]
    for b, s in zip(_leaves(big), _leaves(small)):
        src = s if s.shape[0] == K else s.expand(K, *s.shape[1:])
        b.index_copy_(0, slots, src.to(b.dtype))


@torch.no_grad()
def _admit_rows_shared_prefix(
    params: Params,
    rope,
    prefix_cache: Optional[Cache],  # B=1 cache with the shared prefix KV, or None
    suffixes: torch.Tensor,  # (K, Lbuf) int64, per-row pad-filled (bucketed)
    start: int,  # the shared prefix length (the same for all rows)
    big: Cache,  # the batched cache, written in place
    slots: torch.Tensor,  # (K,) int64 slot of each row
    config: LlamaConfig,
) -> None:
    """Admission for K requests that share one cached prefix: the prefix KV
    is repeated to K rows, the K suffixes are prefilled in ONE forward at
    the shared scalar start (one weight stream instead of K), and each
    row is written into its slot. Each row's padded tail writes KV past
    its real body; decode overwrites position p before attending it, so
    that KV is never seen. The LRU entry itself is never written. With an
    empty suffix the prefix rows are copied as they are (no forward)."""
    K = suffixes.shape[0]
    if suffixes.shape[1] == 0:
        small = prefix_cache if prefix_cache is not None else _zero_rows(big, 1)
    else:
        small = clone_cache(prefix_cache, batch=K) if prefix_cache is not None else _zero_rows(big, K)
        forward(params, suffixes, start, small, config, rope)
    _insert_row(big, small, slots)


def _admit_row(params, rope, prefix_cache, suffix, start, big, slot: int, config) -> None:
    """``_admit_rows_shared_prefix`` for one request into row ``slot``."""
    slots = _to_device(np.array([slot], np.int64), suffix.device)
    _admit_rows_shared_prefix(params, rope, prefix_cache, suffix, start, big, slots, config)


def _apply_admissions(state: Dict[str, torch.Tensor], adm: Dict[str, torch.Tensor]) -> None:
    """Merge this round's admissions into the device-resident slot state
    in place (one host-to-device transfer, no read back). ``pend`` and
    ``pend_rem`` are each slot's queue of prompt tokens not yet fed: every
    admission enqueues at least its LAST prompt token (rem == 1 is the
    classic admission, the first decode feed); piggybacked admissions
    enqueue their whole novel suffix."""
    mask = adm["mask"]
    for k in ("tok", "pos", "remaining", "pend_rem"):
        state[k] = torch.where(mask, adm[k].to(state[k].dtype), state[k])
    state["pend"] = torch.where(mask[:, None], adm["pend"], state["pend"])
    state["pend_idx"] = torch.where(mask, torch.zeros_like(state["pend_idx"]), state["pend_idx"])
    state["live"] = state["live"] | mask


@torch.no_grad()
def _decode_chunk(
    params: Params, rope, cache: Cache, state: Dict[str, torch.Tensor],
    generator: torch.Generator, *, config: LlamaConfig, chunk: int, temperature: float,
    top_p: float, eos_id: int,
) -> torch.Tensor:
    """``chunk`` lockstep decode steps over all S slots at per-row positions
    and bounds, the slot state updated in place on the device; returns the
    (chunk, S) emitted ids (PAD_EMIT where a row emitted nothing). No host
    read. Dead rows feed token 0 at a frozen position: their stale cache
    rows lie past every live row's bound and are overwritten by the next
    admission, or by the row's own writes before it reads them.

    Rows with ``pend_rem > 0`` are still prefilling: they feed their next
    pending prompt token instead of a sampled one and emit PAD (piggyback
    admission). The step that feeds a row's LAST pending token (rem == 1)
    yields its first sampled emission, as the classic last-prompt-token
    feed does."""
    tok, pos, live = state["tok"], state["pos"], state["live"]
    remaining, pend, pend_idx, pend_rem = (state["remaining"], state["pend"],
                                           state["pend_idx"], state["pend_rem"])
    last = pend.shape[1] - 1
    emits = []
    for _ in range(chunk):
        prefilling = pend_rem > 0
        queued = pend.gather(1, pend_idx[:, None].long())[:, 0]
        feed = torch.where(live, torch.where(prefilling, queued, tok), torch.zeros_like(tok))
        logits, cache = forward(params, feed[:, None], pos, cache, config, rope)
        nxt = sample_next_token(logits[:, 0].float(), temperature, top_p, generator)
        emitting = live & (pend_rem <= 1)  # rem == 1: the last prompt token was fed
        emits.append(torch.where(emitting, nxt, torch.full_like(nxt, PAD_EMIT)))
        finished_now = emitting & ((nxt == eos_id) | (remaining <= 1))
        pos = torch.where(live, pos + 1, pos)
        remaining = torch.where(emitting, remaining - 1, remaining)
        feeding = live & prefilling
        pend_idx = torch.where(feeding, torch.clamp(pend_idx + 1, max=last), pend_idx)
        pend_rem = torch.where(feeding, pend_rem - 1, pend_rem)
        live = live & ~finished_now
        tok = torch.where(live & emitting, nxt, tok)
    state.update(tok=tok, pos=pos, live=live, remaining=remaining, pend_idx=pend_idx,
                 pend_rem=pend_rem)
    return torch.stack(emits)


def _bucket(n: int, chunk: int = 64) -> int:
    """Smallest power-of-two multiple of ``chunk`` >= n (a bounded set of
    admission prefill shapes)."""
    b = chunk
    while b < n:
        b *= 2
    return b


@dataclass
class _Slot:
    req: Request
    remaining: int
    toks: List[int] = field(default_factory=list)
    admit_step: int = 0
    admit_wall: float = 0.0


class ContinuousBatcher:
    """Serve a request stream through S always-running decode slots.

    ``llama`` is a generation.Llama (its parameters, config, tokenizer and
    KV-prefix LRU are shared; the batcher owns its own S-row cache).
    temperature=0 gives greedy output, equal to per-request generation.

    ``prefix_sharing=True`` (default) makes admission look up the longest
    LRU prefix of each prompt and prefill only the rest; ``register_prefix``
    and ``serve_prompts`` seed the LRU with a shared context. Admission
    never creates LRU entries on its own (a burst that shares nothing must
    not churn GB-sized cache entries)."""

    def __init__(
        self,
        llama,
        slots: Optional[int] = None,
        chunk: int = 8,
        temperature: float = 0.0,
        top_p: float = 0.9,
        seed: int = 1,
        prefix_sharing: bool = True,
        overlap_fetch: Optional[bool] = None,
        piggyback_max_suffix: Optional[int] = None,
    ):
        refuse_latent(llama.config, "continuous batching (serving='cb')")
        self.llama = llama
        self.config: LlamaConfig = llama.config
        self.params: Params = llama.params
        self.device: torch.device = llama.device
        self.slots = slots or self.config.max_batch_size
        self.chunk = chunk
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.prefix_sharing = prefix_sharing
        # novel suffixes of up to this many tokens (the last prompt token
        # included) are fed through the decode loop instead of a dedicated
        # prefill; 0 disables (every admission prefills)
        if piggyback_max_suffix is None:
            env = os.environ.get("PREGO_CB_PIGGYBACK")
            piggyback_max_suffix = int(env) if env is not None else 4
        # >= 1: every admission enqueues at least its last prompt token
        self.pend_buf = max(int(piggyback_max_suffix), 1)
        # the emits fetch of chunk N-1 behind chunk N: PREGO_CB_OVERLAP=1/0
        # if set, else on for the card and off on the CPU (where the fetch
        # is free and a chunk late only delays admission)
        if overlap_fetch is None:
            env = os.environ.get("PREGO_CB_OVERLAP")
            overlap_fetch = env == "1" if env is not None else self.device.type != "cpu"
        self.overlap_fetch = bool(overlap_fetch)
        self.kv_quant = bool(getattr(llama, "kv_quant", False))
        self._rope = llama.rope
        self.generator = make_generator(int(os.environ.get("PREGO_SAMPLE_SEED", seed)),
                                        self.device)
        self._eos_id = int(getattr(llama.tokenizer, "eos_id", -2))
        self._cache: Optional[Cache] = None  # reused across serve() calls
        self._pinned: List[torch.Tensor] = []  # two host buffers for the overlap fetch
        self.stats = ServeStats()  # serve_prompts' calls, summed

    # --------------------------------------------------------- prefixes

    def register_prefix(self, tokens: Sequence[int]) -> int:
        """Seed the shared LRU with the chunk-aligned prefix of ``tokens``
        (built or extended by the Llama's prefix machinery). Returns the
        aligned length cached (0 when too short)."""
        eff = self.llama.aligned_prefix(len(tokens))
        if eff:
            self.llama.ensure_prefix(tuple(tokens[:eff]))
        return eff

    # --------------------------------------------------------- admission

    def _slot_tensor(self, slots: Sequence[int]) -> torch.Tensor:
        return _to_device(np.asarray(slots, np.int64), self.device)

    def _admit_batch(self, cache: Cache, assignments, stats: ServeStats):
        """Write each (slot, request)'s prompt KV into its slot rows and
        decide how the novel tokens reach the model. Returns ``pend_info``
        with ``pend_info[slot] = (feed_tokens, start_pos)``: the slot's
        pending-token queue for the decode loop.

        Piggyback admissions (novel suffix <= pend_buf): only the cached
        prefix rows are copied (no forward; one copy per shared prefix);
        the whole suffix feeds through the decode loop, one token a step.
        Dedicated admissions prefill the suffix body in one forward
        (requests sharing a prefix in ONE forward) and enqueue only the
        last prompt token, whose forward yields the first sampling logits."""
        groups: Dict[object, List] = {}
        copy_groups: Dict[object, List] = {}
        pend_info: Dict[int, Tuple[List[int], int]] = {}
        for slot, r in assignments:
            body = list(r.prompt[:-1])
            plen, prefix_cache = (self.llama.lookup_prefix(body) if self.prefix_sharing
                                  else (0, None))
            stats.prefills += 1
            if plen:
                stats.prefix_hits += 1
                stats.prefix_tokens_reused += plen
            feed = list(r.prompt[plen:])  # novel tokens incl. the last
            if len(feed) <= self.pend_buf:
                stats.suffix_tokens_piggybacked += len(feed) - 1
                pend_info[slot] = (feed, plen)
                if prefix_cache is not None:
                    key = (plen, id(prefix_cache))
                    copy_groups.setdefault(key, [prefix_cache, []])[1].append(slot)
                # no cached prefix: the slot decodes from position 0 and
                # only ever attends positions it wrote itself, so the stale
                # row needs no clearing
                continue
            suffix = body[plen:]
            stats.suffix_tokens_prefilled += len(suffix)
            pend_info[slot] = ([r.prompt[-1]], len(r.prompt) - 1)
            if not suffix and prefix_cache is None:
                continue
            key = (plen, id(prefix_cache) if prefix_cache is not None else None)
            groups.setdefault(key, [prefix_cache, []])[1].append((slot, suffix))

        empty = torch.zeros((1, 0), dtype=torch.int64, device=self.device)
        for (plen, _), (prefix_cache, pslots) in copy_groups.items():
            # the prefix-KV row copies, one per shared prefix
            _admit_rows_shared_prefix(self.params, self._rope, prefix_cache, empty, plen, cache,
                                      self._slot_tensor(pslots), self.config)

        for (plen, _), (prefix_cache, rows) in groups.items():
            # the padded suffix buffer must fit the rest of the cache window:
            # a bucket past max_seq_len would run the prefill past the cache
            window = self.config.max_seq_len - plen
            assert all(len(s) <= window for _, s in rows)
            longest = max(len(s) for _, s in rows)
            buf = min(_bucket(longest), window) if longest else 0
            padded = np.zeros((len(rows), buf), np.int64)
            for i, (_, s) in enumerate(rows):
                padded[i, : len(s)] = s
            suffixes = _to_device(padded, self.device)
            if len(rows) == 1:
                _admit_row(self.params, self._rope, prefix_cache, suffixes, plen, cache,
                           rows[0][0], self.config)
            else:
                _admit_rows_shared_prefix(self.params, self._rope, prefix_cache, suffixes, plen,
                                          cache, self._slot_tensor([s for s, _ in rows]),
                                          self.config)
        return pend_info

    # ------------------------------------------------------------- fetch

    def _fetch_start(self, emits: torch.Tensor, step: int):
        """Start the copy of a chunk's emits to the host: on the card into
        one of two pinned buffers behind a CUDA event (the host reads
        buffer N-1 while the copy of chunk N fills the other)."""
        if not emits.is_cuda:
            return emits, None, step
        if not self._pinned or self._pinned[0].shape != emits.shape:
            self._pinned = [torch.empty(emits.shape, dtype=emits.dtype, pin_memory=True)
                            for _ in range(2)]
        host = self._pinned[0]
        self._pinned.reverse()
        host.copy_(emits, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event, step

    @staticmethod
    def _fetch_wait(inflight) -> np.ndarray:
        host, event, _ = inflight
        if event is not None:
            event.synchronize()  # the copy has landed
        return host.numpy()

    # ------------------------------------------------------------- loop

    @torch.no_grad()
    def serve(
        self,
        requests: Sequence[Request],
        collect_stats: bool = True,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
    ) -> Tuple[List[Completion], ServeStats]:
        """Run the stream to completion. Requests are admitted in order as
        slots free up; completions return in finish order."""
        cfg = self.config
        S = self.slots
        dev = self.device
        temperature = self.temperature if temperature is None else float(temperature)
        top_p = self.top_p if top_p is None else float(top_p)
        for r in requests:
            if len(r.prompt) + r.max_gen_len > cfg.max_seq_len:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.prompt)} + gen "
                    f"{r.max_gen_len} exceeds max_seq_len {cfg.max_seq_len}"
                )

        t0 = time.perf_counter()
        if self._cache is None:
            self._cache = init_cache(cfg, S, dtype=self.llama.dtype, device=dev,
                                     quantized=self.kv_quant)
        cache = self._cache
        zeros = lambda dtype: torch.zeros((S,), dtype=dtype, device=dev)
        state = dict(tok=zeros(torch.int64), pos=zeros(torch.int32), live=zeros(torch.bool),
                     remaining=zeros(torch.int32),
                     pend=torch.zeros((S, self.pend_buf), dtype=torch.int64, device=dev),
                     pend_idx=zeros(torch.int32), pend_rem=zeros(torch.int32))

        pending = list(requests)
        slots: Dict[int, _Slot] = {}  # host mirror of live slots
        done: List[Completion] = []
        stats = ServeStats()
        step_idx = 0

        def process(emits_h: np.ndarray, end_step: int) -> None:
            """Retire finished slots from one chunk's emissions (the host
            mirrors the device's rule: a slot emits until eos or budget)."""
            if collect_stats:
                stats.decode_steps += self.chunk
                stats.slot_steps_live += int((emits_h != PAD_EMIT).sum())
                stats.slot_steps_total += self.chunk * S
            for s in list(slots):
                st = slots[s]
                new = [int(t) for t in emits_h[:, s] if t != PAD_EMIT]
                st.toks.extend(new)
                st.remaining -= len(new)
                if self._eos_id in new or st.remaining <= 0:
                    slots.pop(s)
                    toks = st.toks
                    if self._eos_id in toks:
                        toks = toks[: toks.index(self._eos_id) + 1]
                    now = time.perf_counter()
                    done.append(
                        Completion(
                            uid=st.req.uid,
                            tokens=toks,
                            prompt_len=len(st.req.prompt),
                            admitted_step=st.admit_step,
                            finished_step=end_step,
                            wall_latency_s=now - st.admit_wall,
                            finished_wall_s=now - t0,
                        )
                    )

        inflight = None  # (emits on the host or in flight, its event, end step)

        # Overlap costs one chunk per serve() call: emissions are handled
        # one chunk late, so after the last real chunk one more chunk of
        # dead rows runs before the host learns that every slot finished.
        # On a long burst that is noise and each chunk hides one fetch; on
        # the PREGO anticipation bursts (8 requests of 8 tokens, chunk 8: one
        # chunk) it doubles the decode work. So overlap only where the
        # expected chunk count amortizes the trailing chunk.
        waves = -(-len(requests) // max(1, S))
        max_gen = max((r.max_gen_len for r in requests), default=0)
        est_chunks = waves * max(1, -(-max_gen // self.chunk))
        use_overlap = self.overlap_fetch and est_chunks >= 4

        while pending or slots or inflight is not None:
            # ---- admit into free slots (cache rows written in place; the
            # decode batch waits only for the admitted suffix prefills)
            if pending:
                assignments = []
                for s in range(S):
                    if s not in slots and pending:
                        r = pending.pop(0)
                        assignments.append((s, r))
                        slots[s] = _Slot(req=r, remaining=r.max_gen_len, admit_step=step_idx,
                                         admit_wall=time.perf_counter())
                if assignments:
                    pend_info = self._admit_batch(cache, assignments, stats)
                    # one transfer: mask, tok, pos, remaining, pend_rem, pend
                    adm = np.zeros((S, 5 + self.pend_buf), np.int64)
                    for s, r in assignments:
                        feed, start = pend_info[s]
                        adm[s, :5] = (1, 0, start, r.max_gen_len, len(feed))
                        adm[s, 5 : 5 + len(feed)] = feed
                    a = _to_device(adm, dev)
                    _apply_admissions(state, dict(mask=a[:, 0] != 0, tok=a[:, 1], pos=a[:, 2],
                                                  remaining=a[:, 3], pend_rem=a[:, 4],
                                                  pend=a[:, 5:]))

            # ---- one chunk of lockstep decode; skipped when only the
            # trailing in-flight fetch remains
            emits = None
            if pending or slots:
                emits = _decode_chunk(
                    self.params, self._rope, cache, state, self.generator, config=cfg,
                    chunk=self.chunk, temperature=temperature, top_p=top_p,
                    eos_id=self._eos_id,
                )
                step_idx += self.chunk

            if not use_overlap:
                if emits is not None:
                    process(emits.cpu().numpy(), step_idx)  # the ONE fetch
            else:
                # chunk N's copy starts before the host handles chunk N-1
                started = self._fetch_start(emits, step_idx) if emits is not None else None
                if inflight is not None:
                    process(self._fetch_wait(inflight), inflight[2])
                inflight = started
        stats.wall_s = time.perf_counter() - t0
        return done, stats

    # ------------------------------------------------- text_completion seam

    def serve_prompts(
        self,
        prompt_tokens: Sequence[Sequence[int]],
        max_gen_len: int,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
    ) -> List[List[int]]:
        """text_completion-shaped entry: serve a batch of tokenized prompts,
        seeding the shared LRU with their COMMON aligned prefix first (the
        sharing structure of the PREGO anticipation dispatch;
        generate_with_prefix_cache computes the same split), and return the
        generated token lists in input order (eos stripped). The call's
        ServeStats are added to ``self.stats``."""
        if not prompt_tokens:
            return []
        self.register_prefix(prompt_tokens[0][: self.llama.shared_prefix(prompt_tokens)])
        reqs = [
            Request(uid=i, prompt=list(t),
                    max_gen_len=min(max_gen_len, self.config.max_seq_len - len(t)))
            for i, t in enumerate(prompt_tokens)
        ]
        done, stats = self.serve(reqs, temperature=temperature, top_p=top_p)
        self.stats.add(stats)
        out: List[List[int]] = [[] for _ in reqs]
        for c in done:  # no PAD_EMIT among the tokens: the cut strips eos
            out[c.uid] = cut_row(c.tokens, PAD_EMIT, self._eos_id)[0]
        return out
