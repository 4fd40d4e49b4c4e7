"""Step-anticipation + mistake-detection entry point (port of
prego_tpu/cli/anticipate.py).

Same flags as the JAX CLI; the LLM backends here are --llm {fake, hf,
ollama, torch-llama}. --quantize [int8|int8x8] and --kv_quant select the
quantized serving modes of torch-llama, --serving cb [--cb_slots N] its
continuous-batching slot loop, --spec_k K --spec_draft D speculative
decoding, and --ckpt_dir with --tokenizer_path a Meta or HF checkpoint in
place of --fabricated weights; --orbax_dir caches a Meta checkpoint's
converted weights (the int8 serving tree under --quantize int8, restored
directly by later runs). --llm hf (a transformers pipeline on --device)
and --llm ollama (an Ollama server at --ollama_host) need --model_name;
the JAX CLI builds its ollama backend without the model name, a fault of
that CLI, which this one does not copy. Data assets
(context prompts, recognizer prediction JSONs, idx2action/idx2emoji symbol
maps) are resolved under --data_root, which can point directly at a
reference-layout step_anticipation/data directory.

Under ``python -m torch.distributed.run --nproc_per_node N -m
prego_tpu_torch.cli.anticipate ...`` the N ranks join one process group
(NCCL on the card, gloo on the CPU), each on its own device
(``cuda:LOCAL_RANK``); torch-llama over a checkpoint directory splits the
model over the ranks in bf16 (tensor parallelism; one card a rank under
--quantize, as the JAX adapter; see ``anticipation/llm.py``), every rank
takes part in every generation, and only rank 0 writes the results.

Examples:
  python -m prego_tpu_torch.cli.anticipate --llm fake --dataset assembly \
      --data_root /path/to/step_anticipation/data --num_samples 2
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama --fabricated 7b \
      --dataset synthcustom --seqs aggregated.json
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama --fabricated 7b \
      --quantize int8 --kv_quant --dataset synthcustom --seqs aggregated.json
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama --fabricated 7b \
      --serving cb --cb_slots 8 --dataset synthcustom --seqs aggregated.json
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama --fabricated 7b \
      --spec_k 4 --spec_draft self-8 --dataset synthcustom --seqs aggregated.json
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama \
      --ckpt_dir llama-2-7b --tokenizer_path tokenizer.model --quantize int8 \
      --orbax_dir llama-2-7b-int8 --dataset synthcustom --seqs aggregated.json
  python -m prego_tpu_torch.cli.anticipate --llm hf --model_name <local HF dir> \
      --dataset synthcustom --seqs aggregated.json --cleaning_mode hf
  python -m prego_tpu_torch.cli.anticipate --llm ollama --model_name llama3.2:1b \
      --dataset synthcustom --seqs aggregated.json
  python -m torch.distributed.run --nproc_per_node 2 -m prego_tpu_torch.cli.anticipate \
      --llm torch-llama --ckpt_dir llama-2-7b --tokenizer_path tokenizer.model \
      --dataset synthcustom --seqs aggregated.json
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import pickle
from typing import List, Optional

from prego_tpu_torch.anticipation import build_llm, run_anticipation, save_results
from prego_tpu_torch.core import get_logger


def load_assets(args):
    data_root = args.data_root
    contexts, toy2class, idx2action, idx2emoji = None, None, None, None

    if args.dataset == "assembly":
        if args.toy_class_context:
            with open(osp.join(data_root, "utils", "toy2class.json")) as f:
                toy2class = json.load(f)
            ctx_path = osp.join(data_root, "context_prompt", "assembly_context_prompt_train.json")
        else:
            ctx_path = osp.join(
                data_root, "context_prompt", "supplementary",
                "assembly_context_prompt_train_onlyToy.json",
            )
        seqs_path = osp.join(
            data_root, "predictions", f"output_{args.recognition_model}_Assembly101-O.json"
        )
        if args.type_prompt == "alpha":
            with open(osp.join(data_root, "idx2action.pkl"), "rb") as f:
                idx2action = pickle.load(f)
    elif args.dataset == "epictent":
        ctx_path = osp.join(data_root, "context_prompt", "epictent_context_prompt_train.json")
        # reference quirk: llama_meta.py:276 points at a stray _edo file; the
        # shipped predictions file is used instead (SURVEY.md §7 quirk table)
        name = "Epic-Tent-O" if args.recognition_model == "OadTR" else "Epic-tent-O"
        seqs_path = osp.join(
            data_root, "predictions", f"output_{args.recognition_model}_{name}.json"
        )
    else:  # custom dataset: flat context (or none), explicit --seqs required
        ctx_path = None
        seqs_path = None

    if args.type_prompt == "emoji":
        with open(osp.join(data_root, "idx2emoji.json")) as f:
            idx2emoji = json.load(f)

    if ctx_path is not None and osp.exists(ctx_path):
        with open(ctx_path) as f:
            contexts = json.load(f)

    if args.seqs is not None:
        seqs_path = args.seqs
    if seqs_path is None:
        raise SystemExit("--seqs is required for custom datasets")
    with open(seqs_path) as f:
        seqs = json.load(f)
    return seqs, contexts, toy2class, idx2action, idx2emoji


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--llm", type=str, default="fake", help="fake | hf | ollama | torch-llama")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None,
                   help="HF model id or local dir for --llm hf; model for --llm ollama")
    p.add_argument("--ollama_host", type=str, default="http://127.0.0.1:11434",
                   help="the Ollama server of --llm ollama")
    p.add_argument("--data_root", type=str, default="step_anticipation/data")
    p.add_argument("--seqs", type=str, default=None, help="path to a predictions/aggregated JSON")
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--fabricated", type=str, default=None,
                   choices=["7b", "13b", "1b", "tiny", "dsv2-lite", "dsv2-tiny"],
                   help="random weights at a reference serving shape — "
                        "TIMING runs of the full driver at scale (metrics "
                        "are meaningless); no --ckpt_dir needed; dsv2-lite is "
                        "DeepSeek-V2-Lite (latent attention, 64 routed + 2 shared "
                        "experts), bf16, batch serving only")
    p.add_argument("--orbax_dir", type=str, default=None,
                   help="cache of a Meta checkpoint's converted weights; with --quantize "
                        "int8 it holds the fused int8 serving tree and later runs restore "
                        "it directly (no conversion, no bf16 stage)")
    p.add_argument("--quantize", nargs="?", const="int8", default=False,
                   choices=["int8", "int8x8"],
                   help="int8 serving for --llm torch-llama: bare flag or 'int8' = "
                        "weight-only; 'int8x8' = int8 weights and per-token int8 "
                        "activations (int8 x int8 products)")
    p.add_argument("--kv_quant", action="store_true",
                   help="int8 KV cache for --llm torch-llama (half the decode cache "
                        "traffic, double the context per GB)")
    p.add_argument("--serving", type=str, default="batch", choices=["batch", "cb"],
                   help="torch-llama dispatch mode: 'batch' = drain-style "
                   "generate (reference semantics); 'cb' = continuous-"
                   "batching slot loop with prefix-sharing admission")
    p.add_argument("--cb_slots", type=int, default=None,
                   help="slot count for --serving cb (default max_batch_size)")
    p.add_argument("--spec_k", type=int, default=0,
                   help="speculative decoding with k-token drafts "
                   "(models/llama/speculative.py); needs --spec_draft")
    p.add_argument("--spec_draft", type=str, default=None,
                   help="draft model: 'self-N' (first N target layers, "
                   "shared weights — zero extra device memory), 'fabricated-1b'/"
                   "'fabricated-tiny' (random weights — machinery demo), "
                   "or a Meta ckpt dir")
    p.add_argument("--max_gen_len", type=int, default=8)
    p.add_argument("--temperature", type=float, default=0.6)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--use_gt", action="store_true")
    p.add_argument("--type_prompt", type=str, default="num")
    p.add_argument("--clean_prediction", action="store_true")
    p.add_argument("--no_eval_metrics", action="store_true")
    p.add_argument("--dataset", type=str, default="assembly")
    p.add_argument("--toy_class_context", action="store_true")
    p.add_argument("--recognition_model", type=str, default="miniROAD")
    p.add_argument("--prompt_context", type=str, default="default")
    p.add_argument("--cleaning_mode", type=str, default="meta", choices=["meta", "hf"])
    p.add_argument("--batch_mode", type=str, default="batched", choices=["batched", "reference"])
    p.add_argument(
        "--step_batch", type=int, default=1,
        help="fold N consecutive steps into one LLM dispatch "
        "(N x num_samples^2 prompts per call; steps are independent)",
    )
    p.add_argument("--results_root", type=str, default="results")
    p.add_argument(
        "--checkpoint_path", type=str, default=None,
        help="persist partial results here every --checkpoint_every videos "
             "and resume from it on restart",
    )
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch-llama and hf device: cuda | cpu (default cuda; raises where "
                        "there is no card)")
    return p.parse_args(argv)


def llm_kwargs(args: argparse.Namespace) -> dict:
    """Validate the backend flags; the keyword arguments of its build."""

    # validate the LLM selection before touching data so flag mistakes fail
    # with their own message, not a data-path error
    from prego_tpu_torch.core.registry import LLMS

    if args.llm not in LLMS:
        raise SystemExit(
            f"unknown --llm {args.llm!r}; known: {', '.join(sorted(LLMS.keys()))}"
        )
    if bool(args.spec_k) != (args.spec_draft is not None):
        raise SystemExit("--spec_k and --spec_draft must be set together")
    if args.spec_k and args.serving == "cb":
        raise SystemExit("--spec_k rides the batch path: speculative decoding is "
                         "incompatible with --serving cb")
    kwargs = {}
    if args.llm in ("hf", "ollama"):
        if not args.model_name:
            raise SystemExit(f"--llm {args.llm} requires --model_name")
        kwargs["model_name"] = args.model_name
        if args.llm == "hf":
            kwargs["device"] = args.device
        else:
            kwargs["host"] = args.ollama_host
    elif args.llm == "torch-llama":
        if not args.fabricated and (not args.ckpt_dir or not args.tokenizer_path):
            raise SystemExit("--llm torch-llama requires --ckpt_dir and --tokenizer_path "
                             "(or --fabricated for a timing run)")
        kwargs.update(
            ckpt_dir=args.ckpt_dir,
            tokenizer_path=args.tokenizer_path,
            max_seq_len=args.max_seq_len,
            max_batch_size=args.max_batch_size,
            fabricated=args.fabricated,
            orbax_dir=args.orbax_dir,
            device=args.device,
            quantize=args.quantize,
            kv_quant=args.kv_quant,
            serving=args.serving,
            cb_slots=args.cb_slots,
            spec_k=args.spec_k,
            spec_draft=args.spec_draft,
        )
    return kwargs


def make_llm(args: argparse.Namespace):
    """The LLM the flags select."""
    return build_llm(args.llm, **llm_kwargs(args))


def prefix_cache_line(llm) -> Optional[str]:
    """The run's closing "prefix cache:" line of a torch-llama ``llm``'s
    counters, else None. A healthy run rebuilds ~once per context, not per
    video or step; per-row calls decode ragged prompts each from its own
    end, and on the card replay their steps from captured graphs (one
    capture a batch size and cache length)."""
    if not hasattr(llm, "llama"):
        return None
    from prego_tpu_torch.models.llama.config import is_latent

    lm = llm.llama
    line = (f"prefix cache: rebuilds={lm.prefix_rebuilds} extends={lm.prefix_extends} "
            f"tokens_reused={lm.prefix_tokens_reused} "
            f"suffix_tokens_prefilled={lm.suffix_tokens_prefilled} "
            f"per_row_calls={lm.per_row_calls} "
            f"decode_steps={lm.decode_steps} graph_captures={lm.decode_graph_captures} "
            f"graph_replays={lm.decode_graph_replays}")
    if is_latent(lm.config):  # DeepSeek-V2: the routed experts' counters
        line += (f"; moe: assignments={lm.moe_assignments} "
                 f"expert_hits={lm.moe_expert_hits} rows_max={lm.moe_rows_max}")
    cb = getattr(llm, "_cb", None)
    if cb is not None:  # --serving cb: the slots' own counts
        st = cb.stats
        line += (f"; cb: tokens_reused={st.prefix_tokens_reused} "
                 f"suffix_tokens_prefilled={st.suffix_tokens_prefilled} "
                 f"suffix_tokens_piggybacked={st.suffix_tokens_piggybacked} "
                 f"decode_steps={st.decode_steps} utilization={st.utilization:.3f}")
    return line


def run(args: argparse.Namespace, llm=None):
    """Anticipate every sequence, report the metrics and save the results;
    ``llm`` defaults to the one the flags select, built after the flags
    are validated and the data is loaded."""
    from prego_tpu_torch.parallel.mesh import init_distributed, is_rank0

    logger = get_logger()
    kwargs = llm_kwargs(args) if llm is None else None
    _, world = init_distributed(args.device)  # a launcher's ranks
    if world > 1 and args.checkpoint_path:
        raise SystemExit("--checkpoint_path is not supported under torch.distributed.run: "
                         "every rank would resume from and write to the same file")
    seqs, contexts, toy2class, idx2action, idx2emoji = load_assets(args)
    if llm is None:
        llm = build_llm(args.llm, **kwargs)
    if hasattr(llm, "llama"):
        logger.info(f"torch-llama over {llm.llama.config.tp_size} tensor-parallel rank(s)")

    result = run_anticipation(
        seqs,
        llm,
        dataset=args.dataset,
        contexts=contexts,
        toy2class=toy2class,
        idx2action=idx2action,
        idx2emoji=idx2emoji,
        use_gt=args.use_gt,
        type_prompt=args.type_prompt,
        prompt_context=args.prompt_context,
        toy_class_context=args.toy_class_context,
        max_gen_len=args.max_gen_len,
        temperature=args.temperature,
        top_p=args.top_p,
        num_samples=args.num_samples,
        cleaning_mode=args.cleaning_mode,
        batch_mode=args.batch_mode,
        step_batch=args.step_batch,
        eval_metrics=not args.no_eval_metrics,
        verbose=args.verbose,
        logger=logger,
        checkpoint_path=args.checkpoint_path,
        checkpoint_every=args.checkpoint_every,
    )

    line = prefix_cache_line(llm)
    if line is not None:
        logger.info(line)
        spec = getattr(llm, "_spec", None)
        if spec is not None and spec.drafts_proposed:
            # the run's realized acceptance (random drafts sit near 0)
            suffix = (" (auto-disabled below break-even mid-run)"
                      if getattr(llm, "_spec_disabled", False) else "")
            logger.info(
                f"speculation: rounds={spec.rounds} "
                f"accepted={spec.drafts_accepted}/{spec.drafts_proposed} "
                f"acceptance={spec.drafts_accepted / spec.drafts_proposed:.3f}{suffix}"
            )
    if result.metrics is not None:
        m = result.metrics
        print(
            "Ratio: {:.3f}\t({:d}/{:d})".format(m["ratio"], m["count"], m["samples"])
        )
        print("TP: {:d}, FP: {:d}, FN: {:d}, TN: {:d}".format(m["tp"], m["fp"], m["fn"], m["tn"]))
        print(
            "Accuracy: {:.3f}, Precision: {:.3f}, Recall: {:.3f}, F1: {:.3f}".format(
                m["accuracy"], m["precision"], m["recall"], m["f1"]
            )
        )

    model_id = (
        args.model_name.split("/")[-1]
        if args.model_name
        else (osp.basename(args.ckpt_dir or "").split("-")[-1] or args.llm)
    )
    if is_rank0():  # the ranks hold the same results: one writes them
        out_dir = save_results(
            result, args.results_root, model_id, args.use_gt, args.type_prompt,
            args.clean_prediction, args.num_samples, args.temperature,
            args.dataset, args.prompt_context, prefix=args.llm.replace("-", "_"),
        )
        logger.info(f"results saved to {out_dir}")
    return result


def main(argv: Optional[List[str]] = None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
