"""Anticipation + mistake-detection driver.

Parity surface: anticipation()/main() shared by the reference drivers
(llama_meta.py:102-217,220-391 primary; llm_hf.py / llm_ollama.py variants).
One implementation here — the reference copy-pastes it three times.

Semantics kept:
  * per step i of a recognized sequence, build the in-context prompt and
    sample the LLM; the anticipated SET is the union of cleaned samples;
  * the reference issues num_samples outer calls each with the prompt
    duplicated num_samples times (llama_meta.py:163-174) — num_samples²
    i.i.d. samples. Here they are batched as ONE device dispatch of
    num_samples² prompts (same distribution; SURVEY.md §7 calls this out),
    with ``batch_mode="reference"`` available to reproduce the loop shape;
  * a step is matched when the recognized symbol is in the anticipated set;
    one-class metrics over {all steps, last step is the mistake};
  * out_plot records anticipated-set size vs history length — kept, but
    passed explicitly instead of a module global (quirk table: fix);
  * results persisted as {prefix}_gts.pkl / {prefix}_preds.pkl / plot.pkl
    in results/<run-id>/ with the reference's run-id format.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from prego_tpu_torch.anticipation.cleaning import clean_generation
from prego_tpu_torch.anticipation.llm import CompletionLLM
from prego_tpu_torch.anticipation.prompts import PromptBuilder, symbolize_sequence
from prego_tpu_torch.metrics.mistake import get_metrics


@dataclass
class AnticipationResult:
    preds: Dict[str, List[Set]] = field(default_factory=dict)
    gts: Dict[str, List] = field(default_factory=dict)
    out_plot: Dict[int, Dict[str, int]] = field(default_factory=dict)
    metrics: Optional[Dict[str, float]] = None
    llm_latencies: List[float] = field(default_factory=list)  # sec per call


def anticipate_sequence(
    seq: Sequence,
    builder: PromptBuilder,
    llm: CompletionLLM,
    max_gen_len: Optional[int] = 8,
    temperature: float = 0.6,
    top_p: float = 0.9,
    num_samples: int = 1,
    cleaning_mode: str = "meta",
    batch_mode: str = "batched",
    out_plot: Optional[Dict[int, Dict[str, int]]] = None,
    verbose: bool = False,
    latencies: Optional[List[float]] = None,  # per-LLM-call wall time (TIME_CNT
    #                                           parity, llm_hf.py:21,47-49)
    step_batch: int = 1,
):
    """Anticipate every step of one video's sequence. Returns (preds, gts).

    ``step_batch > 1`` folds that many CONSECUTIVE STEPS into one LLM
    dispatch (steps are independent: each prompt is built from the
    recognized sequence, never from a previous LLM answer), amortizing
    the per-call fixed cost and filling the device batch —
    step_batch x num_samples² prompts per call. Sample sets and metrics
    are identical in distribution to step_batch=1; with a deterministic
    LLM they are identical outright (tested)."""
    preds: List[Set] = []
    gts: List = []
    if step_batch > 1:
        if batch_mode != "batched":
            raise ValueError("step_batch > 1 requires batch_mode='batched'")
        return _anticipate_sequence_step_batched(
            seq, builder, llm, max_gen_len, temperature, top_p,
            num_samples, cleaning_mode, out_plot, verbose, latencies,
            step_batch,
        )
    for i in range(len(seq)):
        prompt_ = builder.step_prompt(seq, i)
        hist_len = len(builder.history(seq, i))
        action = seq[i]

        if batch_mode == "batched":
            batches = [[prompt_] * (num_samples * num_samples)]
        elif batch_mode == "reference":
            batches = [[prompt_] * num_samples for _ in range(num_samples)]
        else:
            raise ValueError(f"unknown batch_mode {batch_mode!r}")

        pred: Set = set()
        for prompts in batches:
            t_call = time.perf_counter()
            results = llm.text_completion(
                prompts, max_gen_len=max_gen_len, temperature=temperature, top_p=top_p
            )
            if latencies is not None:
                latencies.append(time.perf_counter() - t_call)
            for res in results:
                v = clean_generation(res["generation"], builder.type_prompt, cleaning_mode)
                if out_plot is not None:
                    # set size recorded BEFORE insertion (llama_meta.py:192-196)
                    if hist_len in out_plot:
                        out_plot[hist_len]["sum"] += len(pred)
                        out_plot[hist_len]["count"] += 1
                    else:
                        out_plot[hist_len] = {"sum": len(pred), "count": 1}
                pred.add(v)

        gts.append(action)
        preds.append(pred)
        if verbose:
            print(f"[INFO] >>>> {action} in {pred} ---> {action in pred}")
    return preds, gts


def _anticipate_sequence_step_batched(
    seq, builder, llm, max_gen_len, temperature, top_p, num_samples,
    cleaning_mode, out_plot, verbose, latencies, step_batch,
):
    preds: List[Set] = []
    gts: List = []
    n = num_samples * num_samples
    for c0 in range(0, len(seq), step_batch):
        idxs = range(c0, min(c0 + step_batch, len(seq)))
        prompts: List[str] = []
        metas = []
        for i in idxs:
            prompts.extend([builder.step_prompt(seq, i)] * n)
            metas.append((len(builder.history(seq, i)), seq[i]))
        # pad tail-of-video dispatches to the full step_batch x n prompt
        # count (duplicates of the last prompt, results discarded), so
        # every dispatch of a run has the same batch shape (the JAX
        # package compiles one program per shape)
        n_real = len(prompts)
        if n_real < step_batch * n:
            prompts = prompts + [prompts[-1]] * (step_batch * n - n_real)
        t_call = time.perf_counter()
        results = llm.text_completion(
            prompts, max_gen_len=max_gen_len, temperature=temperature, top_p=top_p
        )[:n_real]
        if latencies is not None:
            latencies.append(time.perf_counter() - t_call)
        for j, (hist_len, action) in enumerate(metas):
            pred: Set = set()
            for res in results[j * n : (j + 1) * n]:
                v = clean_generation(res["generation"], builder.type_prompt, cleaning_mode)
                if out_plot is not None:
                    # set size recorded BEFORE insertion (llama_meta.py:192-196)
                    if hist_len in out_plot:
                        out_plot[hist_len]["sum"] += len(pred)
                        out_plot[hist_len]["count"] += 1
                    else:
                        out_plot[hist_len] = {"sum": len(pred), "count": 1}
                pred.add(v)
            gts.append(action)
            preds.append(pred)
            if verbose:
                print(f"[INFO] >>>> {action} in {pred} ---> {action in pred}")
    return preds, gts


def get_toy(name: str) -> str:
    """Toy id from an Assembly101 video name (llama_meta.py:61-70)."""
    return name.split("-")[2].split("_")[0]


def run_anticipation(
    seqs: Dict[str, Dict[str, List[int]]],
    llm: CompletionLLM,
    dataset: str = "assembly",
    contexts: Optional[Dict] = None,
    toy2class: Optional[Dict[str, str]] = None,
    idx2action: Optional[Dict[int, str]] = None,
    idx2emoji: Optional[Dict[str, Dict[str, str]]] = None,
    use_gt: bool = False,
    type_prompt: str = "num",
    prompt_context: str = "default",
    toy_class_context: bool = False,
    max_gen_len: Optional[int] = 8,
    temperature: float = 0.6,
    top_p: float = 0.9,
    num_samples: int = 1,
    cleaning_mode: str = "meta",
    batch_mode: str = "batched",
    step_batch: int = 1,
    eval_metrics: bool = True,
    verbose: bool = False,
    logger=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    group_by_toy: bool = True,
) -> AnticipationResult:
    """Anticipate + detect mistakes over all videos (llama_meta.py:299-350).

    Unlike the reference — which pickles results only at the very end, so a
    crash mid-run loses everything (SURVEY.md §5) — pass ``checkpoint_path``
    to persist partial preds/gts every ``checkpoint_every`` videos and
    resume: already-finished videos are skipped on restart.
    """
    result = AnticipationResult()
    contexts = contexts or {}
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with open(checkpoint_path, "rb") as f:
            saved = pickle.load(f)
        result.preds.update(saved["preds"])
        result.gts.update(saved["gts"])
        result.out_plot.update(saved.get("out_plot", {}))
        if logger is not None:
            logger.info(f"resuming anticipation: {len(result.preds)} videos done")
    items = list(seqs.items())
    if group_by_toy and dataset == "assembly":
        # The reference iterates videos in raw dict order (llama_meta.py:299),
        # so each toy-context switch pays a fresh prompt-prefix prefill.
        # A free host-side STABLE sort groups videos sharing a context, so
        # the LLM-side prefix cache switches ~#contexts times instead of
        # ~#videos (VERDICT r2 #5). Per-video results are order-independent.
        def context_key(kv):
            toy = get_toy(kv[0])
            if toy_class_context and toy2class is not None:
                return str(toy2class.get(toy, toy))
            return toy

        items.sort(key=context_key)
    for i, (k, v) in enumerate(items):
        if k in result.preds:  # already done in a previous (crashed) run
            continue
        if dataset == "assembly":
            toy = get_toy(k)
            if toy_class_context:
                if toy2class is None:
                    raise ValueError("toy_class_context requires toy2class")
                toy_class = toy2class[toy]
                context = contexts[toy_class][type_prompt]
            else:
                toy_class = None
                context = contexts.get(toy, {}).get(type_prompt, "")
        else:  # epictent and other flat-context datasets
            toy, toy_class = None, None
            context = contexts.get(type_prompt, "") if contexts else ""
        if logger is not None:
            logger.info(f"[{i}/{len(seqs)}] video {k} toy={toy}")

        seq = v["gt"] if use_gt else v["pred"]
        seq = symbolize_sequence(seq, type_prompt, idx2action, idx2emoji)

        builder = PromptBuilder(
            context=context,
            toy=toy,
            toy_class=toy_class,
            type_prompt=type_prompt,
            prompt_context=prompt_context,
        )
        preds, gts = anticipate_sequence(
            seq, builder, llm,
            max_gen_len=max_gen_len, temperature=temperature, top_p=top_p,
            num_samples=num_samples, cleaning_mode=cleaning_mode,
            batch_mode=batch_mode, step_batch=step_batch,
            out_plot=result.out_plot, verbose=verbose,
            latencies=result.llm_latencies,
        )
        result.preds[k] = preds
        result.gts[k] = gts
        if checkpoint_path is not None and (len(result.preds) % checkpoint_every == 0):
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(
                    {"preds": result.preds, "gts": result.gts, "out_plot": result.out_plot},
                    f,
                )
            os.replace(tmp, checkpoint_path)

    if eval_metrics:
        result.metrics = get_metrics(result.preds, result.gts)
        if logger is not None:
            m = result.metrics
            logger.info(
                "Accuracy: {:.3f}, Precision: {:.3f}, Recall: {:.3f}, F1: {:.3f}".format(
                    m["accuracy"], m["precision"], m["recall"], m["f1"]
                )
            )
            if result.llm_latencies:
                logger.info(
                    f"Average LLM call time: "
                    f"{sum(result.llm_latencies) / len(result.llm_latencies):.3f}s"
                )
    return result


def save_results(
    result: AnticipationResult,
    results_root: str,
    model: str,
    use_gt: bool,
    type_prompt: str,
    clean_prediction: bool,
    num_samples: int,
    temperature: float,
    dataset: str,
    prompt_context: str,
    prefix: str = "llama",
) -> str:
    """Persist pickles under the reference's run-id scheme (llama_meta.py:352-391)."""
    save_folder = "{}_{:d}_{}_{:d}_{:d}_{:.2f}_{}_{}".format(
        model, use_gt, type_prompt, int(clean_prediction),
        num_samples, temperature, dataset, prompt_context,
    )
    out_dir = os.path.join(results_root, save_folder)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{prefix}_gts.pkl"), "wb") as f:
        pickle.dump(result.gts, f)
    with open(os.path.join(out_dir, f"{prefix}_preds.pkl"), "wb") as f:
        pickle.dump(result.preds, f)
    with open(os.path.join(out_dir, "plot.pkl"), "wb") as f:
        pickle.dump(result.out_plot, f)
    if result.metrics is not None:
        metrics = dict(result.metrics)
        if result.llm_latencies:
            metrics["mean_llm_call_s"] = sum(result.llm_latencies) / len(
                result.llm_latencies
            )
            metrics["llm_calls"] = len(result.llm_latencies)
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
    return out_dir
