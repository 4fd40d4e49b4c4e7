"""Validate pipeline JSON artifacts against the reference schemas (port of
prego_tpu/cli/schema_check.py; stdlib only).

The practical "baseline" of the reference is its shipped JSON artifacts
(SURVEY.md §6): per-frame recognition output (output_miniRoad/
output_miniROAD.json — {video: {pred: [int/frame], gt: [int/frame]}}),
and aggregated step sequences (data/output/aggregated_data.json —
{video: {pred, gt, changes_pred, changes_gt}}). This tool asserts a
produced artifact has exactly that structure, and optionally that it
covers the same video keys as (or is byte-identical to) a reference file:

  python -m prego_tpu_torch.cli.schema_check perframe out.json [--against ref.json]
  python -m prego_tpu_torch.cli.schema_check aggregated agg.json [--against ref.json \
      [--exact]]

Exit code 0 on pass; 1 with a message on the first violation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _fail(msg: str) -> None:
    raise SystemExit(f"schema_check: FAIL: {msg}")


def _int_list(x, what: str) -> None:
    if not isinstance(x, list) or not all(
        isinstance(v, int) and not isinstance(v, bool) for v in x
    ):
        _fail(f"{what} must be a list of ints")


def check_perframe(data: dict) -> None:
    if not isinstance(data, dict) or not data:
        _fail("per-frame output must be a non-empty {video: ...} dict")
    for vid, rec in data.items():
        if set(rec) != {"pred", "gt"}:
            _fail(f"{vid}: keys must be exactly {{pred, gt}}, got {sorted(rec)}")
        _int_list(rec["pred"], f"{vid}.pred")
        _int_list(rec["gt"], f"{vid}.gt")
        if len(rec["pred"]) != len(rec["gt"]):
            _fail(
                f"{vid}: pred has {len(rec['pred'])} frames, "
                f"gt has {len(rec['gt'])}"
            )
        if not rec["pred"]:
            _fail(f"{vid}: empty frame list")


def check_aggregated(data: dict) -> None:
    if not isinstance(data, dict) or not data:
        _fail("aggregated output must be a non-empty {video: ...} dict")
    for vid, rec in data.items():
        want = {"pred", "gt", "changes_pred", "changes_gt"}
        if set(rec) != want:
            _fail(f"{vid}: keys must be exactly {sorted(want)}, got {sorted(rec)}")
        for k in want:
            _int_list(rec[k], f"{vid}.{k}")
        if len(rec["pred"]) != len(rec["changes_pred"]):
            _fail(f"{vid}: len(pred) != len(changes_pred)")
        if len(rec["gt"]) != len(rec["changes_gt"]):
            _fail(f"{vid}: len(gt) != len(changes_gt)")
        for k in ("pred", "gt"):
            seq = rec[k]
            if any(a == b for a, b in zip(seq, seq[1:])):
                _fail(f"{vid}.{k}: consecutive duplicates survived aggregation")
        for k in ("changes_pred", "changes_gt"):
            ch = rec[k]
            if any(a >= b for a, b in zip(ch, ch[1:])):
                _fail(f"{vid}.{k}: change indices must be strictly increasing")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["perframe", "aggregated"])
    p.add_argument("file")
    p.add_argument(
        "--against", default=None,
        help="reference JSON: assert the same video-key set",
    )
    p.add_argument(
        "--exact", action="store_true",
        help="with --against: assert semantic equality (same parsed content)",
    )
    args = p.parse_args(argv)

    with open(args.file) as f:
        data = json.load(f)
    {"perframe": check_perframe, "aggregated": check_aggregated}[args.kind](data)

    if args.against:
        with open(args.against) as f:
            ref = json.load(f)
        if set(data) != set(ref):
            missing = sorted(set(ref) - set(data))[:5]
            extra = sorted(set(data) - set(ref))[:5]
            _fail(f"video keys differ: missing {missing}, extra {extra}")
        if args.exact and data != ref:
            bad = next(v for v in ref if data[v] != ref[v])
            _fail(f"content differs from reference (first at video {bad!r})")
    print(f"schema_check: OK ({args.kind}, {len(data)} videos)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
