"""The Transformer (ViTEnc) recognizer, port against prego_tpu on the CPU:
forward_train and forward_full on the same parameters at dropout 0 with
patch_dim 1 and 2, causality, dropout drawn from the generator in the
JAX package's places and order, the evaluator's windowed branch, the
bridge for its tree, and the train CLI with model: Transformer. Inputs
are made with numpy from a seed and handed to both sides."""

import jax
import numpy as np
import pytest
import torch
import yaml

from prego_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from prego_tpu.cli.train import main as jax_train_main
from prego_tpu.core import RecognitionConfig as JaxConfig
from prego_tpu.data import load_dataset_info as jax_load_dataset_info
from prego_tpu.data import load_feature_store as jax_load_feature_store
from prego_tpu.models.transformer import TransformerRecognizer as JaxTransformer
from prego_tpu.train import Evaluator as JaxEvaluator
from prego_tpu_torch.checkpoint.bridge import (
    recognizer_from_numpy,
    to_numpy_tree,
    transformer_from_numpy,
)
from prego_tpu_torch.cli.train import main as train_main
from prego_tpu_torch.cli.train import run_eval
from prego_tpu_torch.core import MODELS, RecognitionConfig, make_generator
from prego_tpu_torch.data import load_dataset_info, load_feature_store
from prego_tpu_torch.models import TransformerRecognizer
from prego_tpu_torch.train import Evaluator
from tests.synth import make_synth_dataset
from tests.torch_parity import n, t

# f32 on both sides (embed, LayerNorm, attention, GELU, head, softmax):
# only the summation order of the products differs
TOL = dict(rtol=1e-4, atol=1e-5)

RAW = {
    "model": "Transformer", "rgb_type": "rgb_kinetics_bninception",
    "flow_type": "flow_kinetics_bninception", "embedding_dim": 32, "hidden_dim": 48,
    "num_layers": 2, "num_classes": 6, "dropout": 0.0, "window_size": 8, "num_heads": 4,
    "metric": "AP", "data_name": "SYNTH",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small models: under pytest-xdist each
    worker otherwise starts a thread per core, and the oversubscribed
    threads cost far more than they save at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(patch_dim, **over):
    raw = {**RAW, "patch_dim": patch_dim, **over}
    jm = JaxTransformer(JaxConfig.from_dict(raw))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(patch_dim)))
    # the JAX init leaves cls_token at zero: give it values, so a misplaced token shows
    jparams["cls_token"] = np.random.default_rng(0).normal(0, 0.5, jparams["cls_token"].shape
                                                           ).astype(np.float32)
    return jm, jparams, TransformerRecognizer(RecognitionConfig.from_dict(raw)), \
        transformer_from_numpy(jparams)


@pytest.mark.parametrize("patch_dim", [1, 2])
def test_registered_and_init_tree_like_jax(patch_dim):
    jm, jparams, tm, tparams = _pair(patch_dim)
    assert MODELS.get("Transformer") is TransformerRecognizer
    assert tm.flatten_dim == patch_dim * 2048 and not hasattr(tm, "init_hidden")
    mine = to_numpy_tree(tm.init(make_generator(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert not mine["cls_token"].any() and abs(float(mine["pos"].std()) - 0.02) < 0.005


@pytest.mark.parametrize("flow_is_zero", [False, True])
@pytest.mark.parametrize("patch_dim", [1, 2])
def test_forward_train_matches_jax(patch_dim, flow_is_zero):
    jm, jparams, tm, tparams = _pair(patch_dim)
    rng = np.random.default_rng(1)
    rgb = rng.normal(0, 1, (5, 8, 1024)).astype(np.float32)
    flow = (np.zeros((5, 8, 1024)) if flow_is_zero
            else rng.normal(0, 1, (5, 8, 1024))).astype(np.float32)
    want = jm.forward_train(jparams, rgb, flow, jax.random.PRNGKey(0), flow_is_zero=flow_is_zero)
    got = tm.forward_train(tparams, t(rgb), None if flow_is_zero else t(flow), None,
                           flow_is_zero=flow_is_zero)
    assert got.shape == (5, 6)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("patch_dim", [1, 2])
def test_forward_full_matches_jax(patch_dim):
    """T 70: two chunks of frames, the second partial."""
    jm, jparams, tm, tparams = _pair(patch_dim)
    rng = np.random.default_rng(2)
    rgb = rng.normal(0, 1, (2, 70, 1024)).astype(np.float32)
    flow = rng.normal(0, 1, (2, 70, 1024)).astype(np.float32)
    for softmax in (True, False):
        want = jm.forward_full(jparams, rgb, flow, softmax=softmax)
        got = tm.forward_full(tparams, t(rgb), t(flow), softmax=softmax)
        assert got.shape == (2, 70, 6)
        np.testing.assert_allclose(n(got), n(want), **TOL)


def test_forward_full_is_causal_and_reads_each_frames_window():
    _, _, tm, tparams = _pair(2)
    rng = np.random.default_rng(3)
    rgb = t(rng.normal(0, 1, (1, 40, 1024)).astype(np.float32))
    full = tm.forward_full(tparams, rgb, None, flow_is_zero=True, softmax=False)
    later = rgb.clone()
    later[:, 25:] = t(rng.normal(0, 1, (1, 15, 1024)).astype(np.float32))
    changed = tm.forward_full(tparams, later, None, flow_is_zero=True, softmax=False)
    assert torch.equal(changed[:, :25], full[:, :25])  # no frame sees a later one
    assert not torch.allclose(changed[:, 25:], full[:, 25:])
    padded = torch.cat([torch.zeros(1, 7, 1024), rgb], dim=1)
    for frame in (0, 3, 7, 39):  # the window ending at the frame, zeros before the video
        win = tm.forward_train(tparams, padded[:, frame : frame + 8], None, None,
                               flow_is_zero=True)
        torch.testing.assert_close(full[:, frame], win, rtol=1e-5, atol=1e-6)


def _mask_shapes(tm, B):
    """The masks the JAX package draws, in its order (transformer.py:154-187):
    the positional one, then per block the attention probs, the projection
    (attention rate), the block output, the MLP hidden and the MLP output."""
    S, E, H, F = tm.num_patches + 1, tm.embedding_dim, tm.num_heads, tm.hidden_dim
    rates = [(tm.dropout, (B, S, E))]
    for _ in range(tm.num_layers):
        rates += [(tm.attn_dropout, (B, H, S, S)), (tm.attn_dropout, (B, S, E)),
                  (tm.dropout, (B, S, E)), (tm.dropout, (B, S, F)), (tm.dropout, (B, S, E))]
    return [shape for rate, shape in rates if rate > 0]


@pytest.mark.parametrize("dropout,attn", [(0.1, 0.0), (0.0, 0.2), (0.1, 0.2)])
def test_dropout_draws_from_the_generator_in_the_jax_places(dropout, attn):
    _, _, tm, tparams = _pair(2, dropout=dropout, attn_dropout_rate=attn)
    rgb = t(np.random.default_rng(4).normal(0, 1, (3, 8, 1024)).astype(np.float32))
    a = tm.forward_train(tparams, rgb, None, gen := make_generator(9), flow_is_zero=True)
    b = tm.forward_train(tparams, rgb, None, make_generator(9), flow_is_zero=True)
    assert torch.equal(a, b)  # the same seed, the same masks
    assert not torch.allclose(a, tm.forward_train(tparams, rgb, None, make_generator(10),
                                                  flow_is_zero=True))
    assert not torch.allclose(a, tm.forward_full(tparams, rgb, None, flow_is_zero=True,
                                                 softmax=False)[:, -1])
    ref = make_generator(9)  # the stream advanced by exactly the masks above, in order
    for shape in _mask_shapes(tm, 3):
        torch.rand(shape, generator=ref)
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=ref))
    with pytest.raises(ValueError, match="generator"):
        tm.forward_train(tparams, rgb, None, None, flow_is_zero=True)


def test_bridge_checks_the_transformer_tree():
    _, jparams, _, _ = _pair(1)
    assert set(recognizer_from_numpy(jparams)) == set(jparams)
    bad = {**jparams, "blocks": [{**blk, "qkv": {**blk["qkv"], "b": np.zeros(96, np.float32)}}
                                 for blk in jparams["blocks"]]}
    with pytest.raises(ValueError, match="qkv"):
        transformer_from_numpy(bad)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_transformer")
    data_root, vl_path, _, _ = make_synth_dataset(
        str(root), num_train=2, num_test=2, num_classes=5, rgb_dim=1024, min_len=90,
        max_len=130, seed=4, rgb_type="rgb_kinetics_bninception",
    )
    cfg = {
        **RAW, "task": "OAD", "loss": "NONUNIFORM", "optimizer": "AdamW",
        "feature_pretrained": "synth", "root_path": data_root,
        "flow_type": "flow_anet_resnet50", "annotation_type": "target_perframe",
        "video_list_path": vl_path, "output_path": str(root / "out"), "window_size": 16,
        "batch_size": 8, "num_epoch": 2, "lr": 0.003, "weight_decay": 0.05, "dropout": 0.1,
        "num_classes": 5, "num_layers": 1, "stride": 4,
    }
    path = root / "tr.yaml"
    path.write_text(yaml.dump(cfg))
    return root, path, cfg


def test_evaluator_windowed_branch_matches_jax(synth):
    _, _, cfg = synth
    jm = JaxTransformer(JaxConfig.from_dict(cfg))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm = TransformerRecognizer(RecognitionConfig.from_dict(cfg))
    kw = dict(root_path=cfg["root_path"], rgb_type=cfg["rgb_type"], flow_type=cfg["flow_type"],
              annotation_type="target_perframe", num_classes=5, training=False, window_size=16)
    jinfo = jax_load_dataset_info(cfg["video_list_path"], "SYNTH")
    info = load_dataset_info(cfg["video_list_path"], "SYNTH")
    want_map, want = JaxEvaluator(JaxConfig.from_dict(cfg), jinfo.class_index)(
        jm, jparams, jax_load_feature_store(vids=jinfo.test_session_set, **kw), video_batch=1)
    got_map, got = Evaluator(RecognitionConfig.from_dict(cfg), info.class_index)(
        tm, transformer_from_numpy(jparams), load_feature_store(vids=info.test_session_set, **kw),
        video_batch=1)
    assert got["output"] == want["output"]  # the same argmax on every frame
    # The scores agree to ~2e-7 (forward_full's tolerance), but this untrained
    # model gives some frames exactly equal f32 scores for a class on the JAX
    # side, which the port's rounding orders otherwise: the mAP moved by
    # 1.6e-5 at these ~230 frames. Trained weights (the CLI test below) give
    # the same mAP to 1e-6.
    assert got_map == pytest.approx(want_map, abs=1e-4)
    for c, ap in want["per_class_AP"].items():
        assert got["per_class_AP"][c] == pytest.approx(ap, abs=2e-4)


def test_train_cli_transformer_and_checkpoints_both_ways(synth, tmp_path):
    root, cfg_path, cfg = synth
    out = str(tmp_path / "out")
    best = train_main(["--config", str(cfg_path), "--device", "cpu", "--output_path", out])
    rcfg = RecognitionConfig.from_dict({**cfg, "output_path": out})
    info = load_dataset_info(cfg["video_list_path"], "SYNTH")
    store = load_feature_store(
        root_path=cfg["root_path"], vids=info.test_session_set, rgb_type=cfg["rgb_type"],
        flow_type=cfg["flow_type"], annotation_type="target_perframe", num_classes=5,
        training=False, window_size=16,
    )
    model = TransformerRecognizer(rcfg)
    untrained, _ = Evaluator(rcfg, info.class_index)(model, model.init(make_generator(20)), store)
    assert best > untrained + 0.05
    ckpt, = (tmp_path / "out").glob("*/ckpts/best_*.ckpt")
    ev = ["--eval", str(ckpt), "--output_path", out, "--eval_output_dir", str(tmp_path / "pj")]
    assert jax_train_main(["--config", str(cfg_path), *ev]) == pytest.approx(best, abs=1e-6)
    # a JAX-made checkpoint evaluated by the port and by the JAX CLI
    jcfg = JaxConfig.from_dict(cfg)
    jm = JaxTransformer(jcfg)
    jpath = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(jpath, jm.init(jax.random.PRNGKey(3)))
    want = jax_train_main(["--config", str(cfg_path), "--eval", jpath, "--output_path", out,
                           "--eval_output_dir", str(tmp_path / "pj2")])
    got, _ = run_eval(RecognitionConfig.from_dict(
        {**rcfg.to_dict(), "eval": jpath, "eval_output_dir": str(tmp_path / "pp2")}), "cpu")
    assert got == pytest.approx(want, abs=1e-6)
