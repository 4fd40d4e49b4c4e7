"""Output-directory management (reference: utils/util.py:16-24 create_outdir)."""

from __future__ import annotations

import os
import os.path as osp


def create_outdir(result_path: str) -> str:
    """Create a fresh run directory; auto-suffix _1, _2, ... if it exists."""
    i = 1
    new_result_path = result_path
    while osp.exists(new_result_path):
        new_result_path = f"{result_path}_{i}"
        i += 1
    os.makedirs(osp.join(new_result_path, "ckpts"), exist_ok=True)
    os.makedirs(osp.join(new_result_path, "runs"), exist_ok=True)
    return new_result_path
