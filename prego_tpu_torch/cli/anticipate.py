"""Step-anticipation + mistake-detection entry point (port of
prego_tpu/cli/anticipate.py).

Same flags as the JAX CLI; the LLM backends here are --llm {fake,
torch-llama}. The JAX package's serving options that are not ported yet
(--quantize, --kv_quant, --serving cb, --spec_k, --orbax_dir) are
accepted and refused with the ROADMAP item that ports them. Data assets
(context prompts, recognizer prediction JSONs, idx2action/idx2emoji symbol
maps) are resolved under --data_root, which can point directly at a
reference-layout step_anticipation/data directory.

Examples:
  python -m prego_tpu_torch.cli.anticipate --llm fake --dataset assembly \
      --data_root /path/to/step_anticipation/data --num_samples 2
  python -m prego_tpu_torch.cli.anticipate --llm torch-llama --fabricated 7b \
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
    p.add_argument("--llm", type=str, default="fake", help="fake | torch-llama")
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None, help="HF backend: not ported")
    p.add_argument("--data_root", type=str, default="step_anticipation/data")
    p.add_argument("--seqs", type=str, default=None, help="path to a predictions/aggregated JSON")
    p.add_argument("--max_seq_len", type=int, default=512)
    p.add_argument("--max_batch_size", type=int, default=8)
    p.add_argument("--fabricated", type=str, default=None,
                   choices=["7b", "13b", "1b", "tiny"],
                   help="random weights at a reference serving shape — "
                        "TIMING runs of the full driver at scale (metrics "
                        "are meaningless); no --ckpt_dir needed")
    # the JAX CLI's serving options, refused below until they are ported
    p.add_argument("--orbax_dir", type=str, default=None, help="not ported (ROADMAP M5)")
    p.add_argument("--quantize", nargs="?", const="int8", default=False,
                   choices=["int8", "int8x8"], help="not ported (ROADMAP M5)")
    p.add_argument("--kv_quant", action="store_true", help="not ported (ROADMAP M5)")
    p.add_argument("--serving", type=str, default="batch", choices=["batch", "cb"],
                   help="'batch' (drain-style generate); 'cb' not ported (ROADMAP M6)")
    p.add_argument("--cb_slots", type=int, default=None, help="not ported (ROADMAP M6)")
    p.add_argument("--spec_k", type=int, default=0, help="not ported (ROADMAP M7)")
    p.add_argument("--spec_draft", type=str, default=None, help="not ported (ROADMAP M7)")
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
                   help="torch-llama device: cuda | cpu (default cuda; raises where there is no card)")
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
    unported = {
        "--quantize": (args.quantize, "M5"), "--kv_quant": (args.kv_quant, "M5"),
        "--orbax_dir": (args.orbax_dir, "M5"), "--serving cb": (args.serving == "cb", "M6"),
        "--spec_k": (args.spec_k, "M7"), "--model_name": (args.model_name, "the hf backend"),
    }
    for flag, (value, item) in unported.items():
        if value:
            raise SystemExit(f"{flag} is not ported to PyTorch yet (ROADMAP {item})")
    kwargs = {}
    if args.llm == "torch-llama":
        if not args.fabricated and not args.ckpt_dir:
            raise SystemExit("--llm torch-llama requires --fabricated (or --ckpt_dir)")
        kwargs.update(
            ckpt_dir=args.ckpt_dir,
            tokenizer_path=args.tokenizer_path,
            max_seq_len=args.max_seq_len,
            max_batch_size=args.max_batch_size,
            fabricated=args.fabricated,
            device=args.device,
        )
    return kwargs


def make_llm(args: argparse.Namespace):
    """The LLM the flags select."""
    return build_llm(args.llm, **llm_kwargs(args))


def run(args: argparse.Namespace, llm=None):
    """Anticipate every sequence, report the metrics and save the results;
    ``llm`` defaults to the one the flags select, built after the flags
    are validated and the data is loaded."""
    logger = get_logger()
    kwargs = llm_kwargs(args) if llm is None else None
    seqs, contexts, toy2class, idx2action, idx2emoji = load_assets(args)
    if llm is None:
        llm = build_llm(args.llm, **kwargs)

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

    if hasattr(llm, "llama"):
        # prefix-cache observability: a healthy run rebuilds ~once per
        # context, not per video or step
        logger.info(
            f"prefix cache: rebuilds={llm.llama.prefix_rebuilds} "
            f"extends={llm.llama.prefix_extends}"
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
