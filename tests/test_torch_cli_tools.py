"""The small CLIs (asset_manifest, schema_check, import_reference_data) and
version, port against prego_tpu: each case of tests/test_asset_manifest.py
and tests/test_import_tool.py, and schema_check's passes and failures, run
through both packages' ``main`` on identical copies of the files, with the
same exit codes, the same stdout and stderr (the copies' roots masked) and
the same files afterwards. (test_regression_script_dry_run_green drives a
script of the JAX package and has no twin here.)"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

import prego_tpu.version
import prego_tpu_torch.version
from prego_tpu.cli import asset_manifest as jax_manifest
from prego_tpu.cli import import_reference_data as jax_import
from prego_tpu.cli import schema_check as jax_schema
from prego_tpu_torch.cli import asset_manifest, import_reference_data, schema_check

MANIFEST = Path(__file__).resolve().parents[1] / "configs" / "real_assets_manifest.json"
TWINS = {"asset_manifest": (jax_manifest, asset_manifest),
         "schema_check": (jax_schema, schema_check),
         "import_reference_data": (jax_import, import_reference_data)}


def _run(main, argv, capsys):
    """(exit code, stdout, stderr) of ``main(argv)``."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _files(root: Path):
    """Relative path -> bytes (or the link's target, made relative) of
    every file under ``root``."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.path.relpath(os.readlink(p), root))
        elif p.is_file():
            out[rel] = p.read_bytes().replace(str(root).encode(), b"<root>")
    return out


def _both(tool, tmp_path, capsys, setup, steps):
    """Build the same files under tmp_path/jax and tmp_path/port with
    ``setup(root)``, run ``steps(root)`` (a list of argv lists, or of
    callables taking the root that return one) through each package's
    main, and compare what came out and the files left."""
    results = {}
    for side, mod in zip(("jax", "port"), TWINS[tool]):
        root = tmp_path / side
        root.mkdir()
        setup(root)
        outs = []
        for step in steps:
            argv = step(root) if callable(step) else step
            got = _run(mod.main, [str(a) for a in argv], capsys)
            outs.append(tuple(x.replace(str(root), "<root>") if isinstance(x, str) else x
                              for x in got))
        results[side] = (outs, _files(root))
    assert results["port"] == results["jax"]
    return results["port"][0]


# ---- asset_manifest (tests/test_asset_manifest.py) ----

def _manifest_copy(root, **edit):
    man = json.loads(MANIFEST.read_text())
    for k, v in edit.items():
        man[k] = v
    (root / "manifest.json").write_text(json.dumps(man))


def _epictent_tree(root):
    vids_train, vids_test = ["v_a", "v_b", "v_c"], ["v_d", "v_e"]
    (root / "video_list.json").write_text(json.dumps({"EPIC-TENT-O": {
        "class_index": [f"c{i}" for i in range(12)], "train_session_set": vids_train,
        "test_session_set": vids_test}}))
    feats = root / "features"
    (feats / "rgb_anet_resnet50").mkdir(parents=True)
    (feats / "target_perframe").mkdir()
    rng = np.random.default_rng(0)
    for v in vids_train + vids_test:
        T = int(rng.integers(20, 40))
        np.save(feats / "rgb_anet_resnet50" / f"{v}.npy",
                rng.normal(size=(T, 2048)).astype(np.float32))
        np.save(feats / "target_perframe" / f"{v}.npy", np.zeros((T, 12), np.float32))
    man = json.loads(MANIFEST.read_text())
    man["features"]["epic-tent-O"]["video_list_path"] = str(root / "video_list.json")
    (root / "manifest.json").write_text(json.dumps(man))


def _corrupt(root):
    np.save(root / "features" / "rgb_anet_resnet50" / "v_b.npy", np.zeros((10, 1024), np.float32))
    return ["--manifest", root / "manifest.json", "--dataset", "epic-tent-O",
            "--features_root", root / "features"]


def test_manifest_dry_run_and_strict(tmp_path, capsys):
    outs = _both("asset_manifest", tmp_path, capsys, _manifest_copy, [
        lambda r: ["--manifest", r / "manifest.json", "--dry-run"],
        lambda r: ["--manifest", r / "manifest.json"],
    ])
    assert [o[0] for o in outs] == [0, 1] and "would check" in outs[0][1]


def test_manifest_features_validate_and_catch_bad_shape(tmp_path, capsys):
    strict = lambda r: ["--manifest", r / "manifest.json", "--dataset", "epic-tent-O",
                        "--features_root", r / "features"]
    outs = _both("asset_manifest", tmp_path, capsys, _epictent_tree,
                 [strict, lambda r: [*_corrupt(r), "--dry-run"], strict])
    assert [o[0] for o in outs] == [0, 0, 1]
    assert "5/5 videos validated" in outs[0][1] and "FAIL" in outs[1][1]


def _ckpt(root, name, dims, value):
    import torch

    d = root / name
    d.mkdir(exist_ok=True)
    (d / "params.json").write_text(json.dumps({**dims, "norm_eps": 1e-5, "vocab_size": -1}))
    torch.save({"w": torch.full((4 + int(value),), float(value))}, d / "consolidated.00.pth")
    return d


def test_manifest_checkpoint_record_and_tamper(tmp_path, capsys):
    pytest.importorskip("torch")
    tiny = {"tiny": {"dim": 64, "n_layers": 2, "n_heads": 4, "expected_shards": 1,
                     "shard_sha256_first_mb": None}}
    dims = {"dim": 64, "n_layers": 2, "n_heads": 4}

    def setup(root):
        _manifest_copy(root, checkpoints=tiny)
        _ckpt(root, "ckpt", dims, 0)

    args = lambda r: ["--manifest", r / "manifest.json", "--ckpt_dir", r / "ckpt"]
    outs = _both("asset_manifest", tmp_path, capsys, setup, [
        lambda r: [*args(r), "--dry-run", "--record"],
        lambda r: [*args(r), "--dry-run"],
        lambda r: (_ckpt(r, "ckpt", dims, 1), args(r))[1],
        lambda r: ((r / "ckpt" / "params.json").write_text(
            json.dumps({"dim": 999, "n_layers": 1})), args(r))[1],
    ])
    assert [o[0] for o in outs] == [0, 0, 1, 1]


def test_manifest_draft_checkpoint_contract(tmp_path, capsys):
    pytest.importorskip("torch")
    dims = {"dim": 32, "n_layers": 1, "n_heads": 2}

    def setup(root):
        _manifest_copy(root)
        _ckpt(root, "draft", dims, 0)

    args = lambda r: ["--manifest", r / "manifest.json", "--draft_ckpt_dir", r / "draft"]
    outs = _both("asset_manifest", tmp_path, capsys, setup, [
        lambda r: ["--manifest", r / "manifest.json", "--dry-run"],
        lambda r: [*args(r), "--dry-run", "--record"],
        lambda r: [*args(r), "--dry-run"],
        lambda r: (_ckpt(r, "draft", dims, 1), args(r))[1],
        lambda r: ((r / "draft" / "params.json").write_text(
            json.dumps({"dim": 64, "n_layers": 2})), args(r))[1],
    ])
    assert [o[0] for o in outs] == [0, 0, 0, 1, 1] and "--spec_draft" in outs[0][1]


def test_manifest_bad_sections(tmp_path, capsys):
    def setup(root):
        (root / "empty.json").write_text("{}")
        _manifest_copy(root, features={})

    outs = _both("asset_manifest", tmp_path, capsys, setup, [
        lambda r: ["--manifest", r / "empty.json"],
        lambda r: ["--manifest", r / "manifest.json"],
    ])
    assert [o[0] for o in outs] == [2, 2]


# ---- import_reference_data (tests/test_import_tool.py) ----

def _reference(root):
    ref = root / "ref"
    (ref / "step_recognition" / "data_info").mkdir(parents=True)
    (ref / "step_anticipation" / "data" / "predictions").mkdir(parents=True)
    (ref / "step_recognition" / "data_info" / "video_list.json").write_text(json.dumps(
        {"X": {"class_index": [], "train_session_set": [], "test_session_set": []}}))
    (ref / "step_anticipation" / "data" / "predictions" / "p.json").write_text("{}")


def test_import_copy_link_and_overwrite(tmp_path, capsys):
    outs = _both("import_reference_data", tmp_path, capsys, _reference, [
        lambda r: ["--reference", r / "ref", "--dest", r / "ws"],
        lambda r: ["--reference", r / "ref", "--dest", r / "ws2", "--link"],
        lambda r: ["--reference", r / "ref", "--dest", r / "ws2"],  # over the links
        lambda r: ["--reference", r / "nothing", "--dest", r / "ws3"],
    ])
    assert [o[0] for o in outs] == [None, None, None, outs[3][0]]
    assert "imported data_info/video_list.json" in outs[0][1]
    assert "is it a PREGO checkout" in str(outs[3][0])
    for side in ("jax", "port"):
        assert not (tmp_path / side / "ws2" / "data_info" / "video_list.json").is_symlink()


def test_import_assets_function_equal(tmp_path):
    _reference(tmp_path)
    got = import_reference_data.import_assets(str(tmp_path / "ref"), str(tmp_path / "a"), True)
    want = jax_import.import_assets(str(tmp_path / "ref"), str(tmp_path / "b"), True)
    assert got == want == ["data_info/video_list.json", "step_anticipation/data"]
    assert (tmp_path / "a" / "data_info" / "video_list.json").is_symlink()
    assert import_reference_data.import_assets(str(tmp_path / "no"), str(tmp_path / "c")) == []


# ---- schema_check ----

PERFRAME = {"v1": {"pred": [0, 1, 1, 2], "gt": [0, 1, 2, 2]}, "v2": {"pred": [3], "gt": [3]}}
AGG = {"v1": {"pred": [0, 1, 2], "gt": [0, 1, 2], "changes_pred": [0, 1, 3],
              "changes_gt": [0, 1, 2]}}


def _schema_files(root):
    files = {
        "perframe.json": PERFRAME,
        "perframe_other.json": {"v1": PERFRAME["v1"]},
        "agg.json": AGG,
        "agg_moved.json": {"v1": {**AGG["v1"], "pred": [0, 2, 1]}},
        "agg_dup.json": {"v1": {**AGG["v1"], "pred": [0, 0, 2]}},
        "agg_keys.json": {"v1": {"pred": [0]}},
        "perframe_len.json": {"v1": {"pred": [0, 1], "gt": [0]}},
        "perframe_bool.json": {"v1": {"pred": [True], "gt": [0]}},
        "empty.json": {},
    }
    for name, data in files.items():
        (root / name).write_text(json.dumps(data))


@pytest.mark.parametrize("argv, rc", [
    (["perframe", "perframe.json"], 0),
    (["perframe", "perframe.json", "--against", "perframe.json", "--exact"], 0),
    (["perframe", "perframe.json", "--against", "perframe_other.json"], "fail"),
    (["aggregated", "agg.json", "--against", "agg_moved.json"], 0),
    (["aggregated", "agg.json", "--against", "agg_moved.json", "--exact"], "fail"),
    (["aggregated", "agg_dup.json"], "fail"),
    (["aggregated", "agg_keys.json"], "fail"),
    (["perframe", "perframe_len.json"], "fail"),
    (["perframe", "perframe_bool.json"], "fail"),
    (["perframe", "empty.json"], "fail"),
])
def test_schema_check_equal(tmp_path, capsys, argv, rc):
    steps = [lambda r, a=argv: [a[0], r / a[1], *[r / x if x.endswith(".json") else x
                                                  for x in a[2:]]]]
    (got_rc, out, _), = _both("schema_check", tmp_path, capsys, _schema_files, steps)
    if rc == 0:
        assert got_rc == 0 and out.startswith("schema_check: OK")
    else:
        assert str(got_rc).startswith("schema_check: FAIL")


def test_version_equal():
    assert prego_tpu_torch.version.__version__ == prego_tpu.version.__version__
