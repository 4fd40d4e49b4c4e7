"""Offline anticipation (PREGO's protocol) with DeepSeek-V2 as the
anticipator: ``loops/anticipate.py``'s closed loop, one completion call a
video through ``TorchLlamaLLM(params=, config=DeepseekV2Config,
serving="batch")``, with its own model, FLOPs and reference.

The configuration file's ``llm`` block holds the keys a LLaMA block shares
(dim, n_layers, n_heads, vocab_size, ffn_hidden: the dense layers' width,
norm_eps, rope_theta), its ``deepseek_v2`` block the architecture's own
(MLA's widths, the experts, the first dense layers, YaRN). Each call also
keeps the port's MoE counters of that call (``Llama.moe_last_counts``:
rows a (forward, MoE layer, expert)), which the per-layer readers use.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from perf_bench import gen, moe_counts, weights
from perf_bench.loops import Check, limit_of
from perf_bench.loops import anticipate
from perf_bench.reference import deepseek_v2 as ref_dsv2
from perf_bench.reference import f32_exact
from perf_bench.reference import prompts as ref_prompts


def dsv2_config(c: Dict, t: Dict):
    """The port's DeepseekV2Config of the merged configuration blocks."""
    from prego_tpu_torch.models.llama.config import DeepseekV2Config

    rs = c["rope_scaling"]
    if c["norm_topk_prob"] or c["routed_scaling_factor"] != 1:
        raise ValueError("the port weights the routed experts by their scores as they are: "
                         "norm_topk_prob false and routed_scaling_factor 1")
    return DeepseekV2Config(
        dim=c["dim"], n_layers=c["n_layers"], n_heads=c["n_heads"], n_kv_heads=c["n_heads"],
        vocab_size=c["vocab_size"], norm_eps=c["norm_eps"], rope_theta=c["rope_theta"],
        max_batch_size=t["max_batch_size"], max_seq_len=t["max_seq_len"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        intermediate_size=c["ffn_hidden"], moe_intermediate_size=c["moe_intermediate_size"],
        n_routed_experts=c["n_routed_experts"], n_shared_experts=c["n_shared_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"], moe_layer_freq=c["moe_layer_freq"],
        rope_factor=float(rs["factor"]),
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]), rope_mscale_all_dim=float(rs["mscale_all_dim"]))


def dsv2_tree(cfg, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """A random DeepSeek-V2 tree of the port's DeepseekV2Config ``cfg``, in
    the port's serving layout (``latent_layout``, ``latent_tree``): every
    matrix N(0, 1/d_in), drawn in one buffer a distinct input width, each
    matrix a contiguous piece of it (``weights.py``'s way), then the
    embedding N(0, 1/D); norms 1."""
    from prego_tpu_torch.models.llama.model import latent_layout, latent_tree

    g = weights._generator(seed, device)
    shapes = [shape for _, shape in latent_layout(cfg)]
    leaves: List = [None] * len(shapes)
    for d_in in dict.fromkeys(s[-2] for s in shapes):
        idx = [j for j, s in enumerate(shapes) if s[-2] == d_in]
        mine = [shapes[j] for j in idx]
        buf = weights._normal(sum(int(np.prod(s)) for s in mine), d_in ** -0.5, g, device, dtype)
        for j, leaf in zip(idx, weights._carve(buf, mine)):
            leaves[j] = leaf
    V, D = cfg.vocab_size, cfg.dim
    emb = weights._normal(V * D, D ** -0.5, g, device, dtype).view(V, D)
    return latent_tree(cfg, leaves, emb, dtype, device)


class Loop(anticipate.Loop):
    def __init__(self, cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        self.c = {**cell.config["llm"], **cell.config["deepseek_v2"]}

    def setup(self) -> None:
        # a port without DeepSeek-V2 fails here, before any weight is drawn
        from prego_tpu_torch.anticipation.llm import TorchLlamaLLM
        from prego_tpu_torch.anticipation.prompts import PromptBuilder

        os.environ["PREGO_SAMPLE_SEED"] = str(self.seed % (1 << 31))
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        cfg = dsv2_config(self.c, self.t)
        self.tree = dsv2_tree(cfg, self.seed, self.device, dtype)
        self.llm = TorchLlamaLLM(params=self.tree, config=cfg, device=str(self.device),
                                 serving="batch")
        self.tokens = anticipate.ServedTokens(self.llm.llama.tokenizer)
        self.llm.llama.tokenizer = self.tokens
        self.coll = gen.make_collection(self.t, self.seed)
        self.prompters = [PromptBuilder(context=ctx, toy=toy)
                          for ctx, toy in zip(self.coll.contexts, self.coll.toys)]
        for i in range(int(self.t["warmup_calls"])):
            self._call(i)

    def _call(self, i: int) -> anticipate.Call:
        call = super()._call(i)
        # rows a (forward, MoE layer, expert) of this call's one generation
        call.moe = self.llm.llama.moe_last_counts
        return call

    def call_flops(self, call: anticipate.Call) -> float:
        return moe_counts.call_flops(self.c, self.prompt_ids(call), [len(s) for s in call.served])

    def check(self) -> List[Check]:
        """``anticipate.Loop.check`` against the DeepSeek-V2 reference: the
        mean gap of the sampled greedy served tokens' reference logits below
        the reference's best, and every prompt answered."""
        f32_exact()
        missing = sum(max(c.rows - len(c.served), 0) for c in self.calls)
        requests = [(c, j) for c in self.calls if c.greedy for j in range(len(c.served))]
        ids = {}

        def prompt(c, j):
            if c.index not in ids:
                ids[c.index] = self.prompt_ids(c)
            return ids[c.index][j]

        prompts, served = anticipate.sample_requests(requests, prompt, lambda c, j: c.served[j],
                                                     self.seed, int(self.t["check_tokens"]))
        self.checked = (prompts, served)
        self.gaps = ref_dsv2.served_gaps(
            self.tree, self.c, prompts, served, eos=ref_prompts.EOS,
            max_gen=int(self.t["max_gen_len"])) if prompts else []
        flat = [g for row in self.gaps for g in row]
        mean = sum(flat) / len(flat) if flat else float("nan")
        return [Check("mean_gap", mean, limit_of(self.cell.limits, "mean_gap")),
                Check("missing_answers", float(missing), 0.0)]
