"""Real-asset onramp manifest: declare + validate the external assets the
real-data parity run needs (port of prego_tpu/cli/asset_manifest.py;
stdlib only, the port's own video list and tokenizer readers).

The repository ships NO real TSN features, tokenizer.model, or LLaMA
checkpoints, so end-to-end parity-F1 has never run with real
numerics.  This tool removes the discovery friction for the day assets
exist: a JSON manifest declares every expected asset (path pattern, shape
contract, optional sha256), and

  python -m prego_tpu_torch.cli.asset_manifest --manifest configs/real_assets_manifest.json \
      --features_root /data/assembly101 --ckpt_dir /data/llama-2-7b \
      --tokenizer_path /data/tokenizer.model [--dataset assembly101-O]

validates whatever is present.  Modes:

  --dry-run   validate the MANIFEST itself and report, per asset, found /
              missing / would-check — always exit 0 (the in-suite mode;
              nothing in the repository satisfies the manifest)
  (default)   strict: every asset must exist and pass its contract
  --record    after validating shapes, write observed sha256 digests back
              into the manifest (first contact with real assets pins them)

Shape contracts come from the reference:
  * per-video feature .npy: (T, dim) with dim per FEATURE_SIZES
    (step_recognition/datasets/dataset.py:11-21); targets (T, num_classes)
  * video lists: data_info/video_list.json counts (Assembly101-O 86
    classes / 135 train / 182 test; Epic-tent-O 12 / 13 / 15)
  * tokenizer.model: SentencePiece ModelProto, 32000 pieces
    (llama/tokenizer.py:13-35)
  * Meta checkpoint dir: params.json + consolidated.NN.pth, one shard per
    TP rank (llama/generation.py:101-106); 7B dim 4096 / 13B dim 5120
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os.path as osp
import sys
from typing import Dict, List, Optional


def _sha256(path: str, limit: Optional[int] = None) -> str:
    h = hashlib.sha256()
    read = 0
    with open(path, "rb") as f:
        while True:
            blk = f.read(1 << 20)
            if not blk:
                break
            h.update(blk)
            read += len(blk)
            if limit is not None and read >= limit:
                break
    return h.hexdigest()


class Report:
    def __init__(self):
        self.rows: List[Dict] = []

    def add(self, asset: str, status: str, detail: str = ""):
        self.rows.append({"asset": asset, "status": status, "detail": detail})
        print(f"[{status:>9}] {asset}" + (f" — {detail}" if detail else ""))

    @property
    def failures(self) -> List[Dict]:
        return [r for r in self.rows if r["status"] == "FAIL"]

    @property
    def missing(self) -> List[Dict]:
        return [r for r in self.rows if r["status"] == "missing"]


def _check_npy_shape(path: str, dim: int, rep: Report, asset: str) -> Optional[int]:
    """Validate (T, dim) without loading the payload (header-only read).
    Returns T on success."""
    import numpy as np

    try:
        arr = np.load(path, mmap_mode="r")
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        rep.add(asset, "FAIL", f"unreadable npy: {e}")
        return None
    if arr.ndim != 2 or arr.shape[1] != dim:
        rep.add(asset, "FAIL", f"shape {arr.shape}, want (T, {dim})")
        return None
    return int(arr.shape[0])


def validate_features(
    manifest: Dict, features_root: Optional[str], dataset: str, rep: Report,
) -> None:
    spec = manifest["features"][dataset]
    if not features_root or not osp.isdir(features_root):
        rep.add(
            f"features[{dataset}]", "missing",
            f"FEATURES_ROOT absent; would check {spec['rgb_type']}/"
            f"<video>.npy (T,{spec['rgb_dim']}), {spec['annotation_type']}/"
            f"<video>.npy (T,{spec['num_classes']}) for "
            f"{spec['num_train']}+{spec['num_test']} videos",
        )
        return
    from prego_tpu_torch.data.video_list import load_video_list

    vl = load_video_list(spec["video_list_path"])[spec["data_name"]]
    vids = list(vl.train_session_set) + list(vl.test_session_set)
    n_ok = 0
    for vid in vids:
        fpath = osp.join(features_root, spec["rgb_type"], vid + ".npy")
        tpath = osp.join(features_root, spec["annotation_type"], vid + ".npy")
        if not osp.exists(fpath) or not osp.exists(tpath):
            rep.add(f"features[{dataset}]/{vid}", "missing", fpath)
            continue
        t1 = _check_npy_shape(fpath, spec["rgb_dim"], rep, f"rgb/{vid}")
        t2 = _check_npy_shape(tpath, spec["num_classes"], rep, f"target/{vid}")
        if t1 is not None and t2 is not None:
            if t1 != t2:
                rep.add(f"features[{dataset}]/{vid}", "FAIL",
                        f"rgb T={t1} != target T={t2}")
            else:
                n_ok += 1
    rep.add(
        f"features[{dataset}]", "ok" if n_ok == len(vids) else "partial",
        f"{n_ok}/{len(vids)} videos validated",
    )


def validate_tokenizer(
    manifest: Dict, tokenizer_path: Optional[str], rep: Report,
    record: bool,
) -> None:
    spec = manifest["tokenizer"]
    if not tokenizer_path:
        rep.add(
            "tokenizer.model", "skipped",
            f"no --tokenizer_path; would check SentencePiece ModelProto "
            f"with {spec['n_words']} pieces + sha256"
            + (f"={spec['sha256'][:12]}…" if spec.get("sha256") else " (unpinned)"),
        )
        return
    if not osp.exists(tokenizer_path):
        rep.add("tokenizer.model", "missing", tokenizer_path)
        return
    from prego_tpu_torch.models.llama.tokenizer import load_tokenizer

    try:
        tok = load_tokenizer(tokenizer_path)
    except Exception as e:  # noqa: BLE001
        rep.add("tokenizer.model", "FAIL", f"unparsable: {e}")
        return
    if tok.n_words != spec["n_words"]:
        rep.add("tokenizer.model", "FAIL",
                f"n_words {tok.n_words} != {spec['n_words']}")
        return
    digest = _sha256(tokenizer_path)
    if spec.get("sha256") and digest != spec["sha256"]:
        rep.add("tokenizer.model", "FAIL", f"sha256 {digest[:12]}… != pinned")
        return
    if record:
        spec["sha256"] = digest
    rep.add("tokenizer.model", "ok", f"{tok.n_words} pieces, sha256 {digest[:12]}…")


def validate_checkpoint(
    manifest: Dict, ckpt_dir: Optional[str], rep: Report, record: bool,
) -> None:
    import glob

    specs = manifest["checkpoints"]
    sizes = ", ".join(
        f"{k}: dim {v['dim']}, {v['n_layers']} layers" for k, v in specs.items()
    )
    if not ckpt_dir:
        rep.add(
            "meta checkpoint", "skipped",
            f"no --ckpt_dir; would check params.json dims against one of "
            f"[{sizes}] and count consolidated.NN.pth shards (== TP world size)",
        )
        return
    if not osp.isdir(ckpt_dir):
        rep.add("meta checkpoint", "missing", ckpt_dir)
        return
    pj = osp.join(ckpt_dir, "params.json")
    if not osp.exists(pj):
        rep.add("meta checkpoint", "FAIL", f"no params.json in {ckpt_dir}")
        return
    with open(pj) as f:
        params = json.load(f)
    match = next(
        (k for k, v in specs.items()
         if params.get("dim") == v["dim"] and params.get("n_layers") == v["n_layers"]),
        None,
    )
    shards = sorted(glob.glob(osp.join(ckpt_dir, "consolidated.*.pth")))
    if match is None:
        rep.add("meta checkpoint", "FAIL",
                f"params.json dims {params.get('dim')}/{params.get('n_layers')} "
                "match no known size")
        return
    if not shards:
        rep.add("meta checkpoint", "FAIL", "no consolidated.*.pth shards")
        return
    if record:
        specs[match]["shard_sha256_first_mb"] = [
            _sha256(s, limit=1 << 20) for s in shards
        ]
    pinned = specs[match].get("shard_sha256_first_mb")
    if pinned:
        got = [_sha256(s, limit=1 << 20) for s in shards]
        if got != pinned:
            rep.add("meta checkpoint", "FAIL", "shard digests differ from pinned")
            return
    rep.add("meta checkpoint", "ok",
            f"{match}: {len(shards)} shard(s) (TP world size)")


def validate_draft_checkpoint(
    manifest: Dict, draft_dir: Optional[str], rep: Report, record: bool,
) -> None:
    """``--spec_draft <ckpt_dir>`` contract (speculative decoding): a
    Meta-format DRAFT checkpoint — params.json with its own (smaller)
    dims, consolidated shards = its TP world size.  Any dim is valid a
    priori (the draft only has to share the target's vocabulary, asserted
    at load — models/llama/speculative.py::SpeculativeLlama); dims and
    shard digests are pinned on first contact via --record so the asset
    is validated the day it exists."""
    import glob

    spec = manifest.get("draft_checkpoint")
    if spec is None:
        return
    if not draft_dir:
        pinned = (
            f"pinned {spec['dim']}d/{spec['n_layers']}L"
            if spec.get("dim") else "unpinned"
        )
        rep.add(
            "draft checkpoint", "skipped",
            f"no --draft_ckpt_dir; would check params.json ({pinned}) + "
            "consolidated.NN.pth shard digests for --spec_draft <ckpt_dir>",
        )
        return
    if not osp.isdir(draft_dir):
        rep.add("draft checkpoint", "missing", draft_dir)
        return
    pj = osp.join(draft_dir, "params.json")
    if not osp.exists(pj):
        rep.add("draft checkpoint", "FAIL", f"no params.json in {draft_dir}")
        return
    with open(pj) as f:
        params = json.load(f)
    dim, n_layers = params.get("dim"), params.get("n_layers")
    if not isinstance(dim, int) or not isinstance(n_layers, int):
        rep.add("draft checkpoint", "FAIL",
                f"params.json dims unreadable: dim={dim} n_layers={n_layers}")
        return
    shards = sorted(glob.glob(osp.join(draft_dir, "consolidated.*.pth")))
    if not shards:
        rep.add("draft checkpoint", "FAIL", "no consolidated.*.pth shards")
        return
    if record:
        spec["dim"], spec["n_layers"] = dim, n_layers
        spec["expected_shards"] = len(shards)
        spec["shard_sha256_first_mb"] = [
            _sha256(s, limit=1 << 20) for s in shards
        ]
    if spec.get("dim") is not None and (dim, n_layers) != (
        spec["dim"], spec["n_layers"]
    ):
        rep.add("draft checkpoint", "FAIL",
                f"dims {dim}/{n_layers} != pinned "
                f"{spec['dim']}/{spec['n_layers']}")
        return
    pinned = spec.get("shard_sha256_first_mb")
    if pinned:
        got = [_sha256(s, limit=1 << 20) for s in shards]
        if got != pinned:
            rep.add("draft checkpoint", "FAIL",
                    "shard digests differ from pinned")
            return
    rep.add("draft checkpoint", "ok",
            f"dim {dim}, {n_layers} layers, {len(shards)} shard(s)")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", required=True)
    p.add_argument("--features_root", default=None)
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--draft_ckpt_dir", default=None,
                   help="speculative-decoding draft checkpoint "
                        "(--spec_draft <ckpt_dir>)")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--dataset", default="assembly101-O",
                   choices=["assembly101-O", "epic-tent-O"])
    p.add_argument("--dry-run", action="store_true",
                   help="report found/missing/would-check; always exit 0")
    p.add_argument("--record", action="store_true",
                   help="pin observed sha256 digests back into the manifest")
    args = p.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)
    for key in ("features", "tokenizer", "checkpoints"):
        if key not in manifest:
            print(f"manifest missing section {key!r}", file=sys.stderr)
            return 2
    if args.dataset not in manifest["features"]:
        print(f"manifest has no features[{args.dataset}]", file=sys.stderr)
        return 2

    rep = Report()
    validate_features(manifest, args.features_root, args.dataset, rep)
    validate_tokenizer(manifest, args.tokenizer_path, rep, args.record)
    validate_checkpoint(manifest, args.ckpt_dir, rep, args.record)
    validate_draft_checkpoint(manifest, args.draft_ckpt_dir, rep, args.record)

    if args.record:
        with open(args.manifest, "w") as f:
            json.dump(manifest, f, indent=2)
        print(f"manifest updated: {args.manifest}")

    if rep.failures:
        print(f"{len(rep.failures)} FAILURES", file=sys.stderr)
        if args.dry_run:  # documented contract: dry-run always exits 0
            print("(dry-run: reported, not fatal)", file=sys.stderr)
        else:
            return 1
    if rep.missing and not args.dry_run:
        print(f"{len(rep.missing)} assets missing (strict mode)", file=sys.stderr)
        return 1
    if args.dry_run and rep.failures:
        # exit-0 contract holds, but stdout must not read as a clean
        # validation when pinned contracts failed
        print(
            f"manifest validation (dry-run) completed with "
            f"{len(rep.failures)} FAILURES (see stderr)"
        )
    else:
        print(
            "manifest validation "
            + ("(dry-run) " if args.dry_run else "") + "OK"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
