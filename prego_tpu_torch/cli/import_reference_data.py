"""Import data assets from a reference PREGO checkout (port of
prego_tpu/cli/import_reference_data.py; stdlib only).

A user of the reference keeps dataset-side assets (video lists, context
prompts, symbol maps, recognizer prediction JSONs) inside the reference
repo layout. This tool copies/links them into a prego_tpu workspace so
every CLI runs unchanged:

  python -m prego_tpu_torch.cli.import_reference_data --reference /path/to/PREGO \
      --dest ./workspace [--link]

Assets imported (reference paths):
  step_recognition/data_info/video_list.json -> data_info/video_list.json
  step_anticipation/data/                     -> step_anticipation/data/
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
from typing import List, Optional

ASSETS = [
    ("step_recognition/data_info/video_list.json", "data_info/video_list.json"),
    ("step_anticipation/data", "step_anticipation/data"),
]


def import_assets(reference: str, dest: str, link: bool = False) -> List[str]:
    imported = []
    for src_rel, dst_rel in ASSETS:
        src = osp.join(reference, src_rel)
        dst = osp.join(dest, dst_rel)
        if not osp.exists(src):
            continue
        os.makedirs(osp.dirname(dst) or ".", exist_ok=True)
        if osp.lexists(dst):
            if osp.islink(dst):
                os.unlink(dst)
            elif osp.isdir(dst):
                shutil.rmtree(dst)
            else:
                os.remove(dst)
        if link:
            os.symlink(osp.abspath(src), dst)
        elif osp.isdir(src):
            shutil.copytree(src, dst)
        else:
            shutil.copy2(src, dst)
        imported.append(dst_rel)
    return imported


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference", required=True, help="path to a PREGO checkout")
    p.add_argument("--dest", default=".", help="workspace destination")
    p.add_argument("--link", action="store_true", help="symlink instead of copying")
    args = p.parse_args(argv)
    imported = import_assets(args.reference, args.dest, args.link)
    if not imported:
        raise SystemExit(
            f"no known assets found under {args.reference!r} — is it a PREGO checkout?"
        )
    for rel in imported:
        print(f"imported {rel}")


if __name__ == "__main__":
    main()
