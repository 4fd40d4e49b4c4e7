"""The ANTICIPATION task, port against prego_tpu on the CPU: MiniROADA's
forwards on the same parameters (dropout 0), the anticipation loss, three
AdamW train steps, AntEvaluator's result dict, the bridge for its tree,
and the train CLI on --task ANTICIPATION with its checkpoint evaluated by
the JAX CLI (and the JAX package's by the port). Inputs are made with
numpy from a seed and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prego_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from prego_tpu.cli.train import main as jax_train_main
from prego_tpu.core import RecognitionConfig as JaxConfig
from prego_tpu.data import load_dataset_info as jax_load_dataset_info
from prego_tpu.data import load_feature_store as jax_load_feature_store
from prego_tpu.models.miniroad_a import MiniROADA as JaxMiniROADA
from prego_tpu.train import build_optimizer as jax_build_optimizer
from prego_tpu.train.evaluator import AntEvaluator as JaxAntEvaluator
from prego_tpu.train.loss import anticipation_mlce as jax_anticipation_mlce
from prego_tpu.train.lr_schedule import warmup_cosine_schedule as jax_schedule
from prego_tpu.train.trainer import make_ant_train_step as jax_make_ant_train_step
from prego_tpu_torch.checkpoint import load_checkpoint
from prego_tpu_torch.checkpoint.bridge import miniroad_from_numpy, to_numpy_tree
from prego_tpu_torch.cli.train import main as train_main
from prego_tpu_torch.cli.train import run_eval, run_train
from prego_tpu_torch.core import MODELS, RecognitionConfig, make_generator
from prego_tpu_torch.data import load_dataset_info, load_feature_store
from prego_tpu_torch.models import MiniROADA
from prego_tpu_torch.train import (
    AntEvaluator,
    anticipation_mlce,
    build_optimizer,
    make_ant_train_step,
    update_count,
    warmup_cosine_schedule,
)
from tests.synth import make_synth_dataset
from tests.torch_parity import n, t

# f32 on both sides: only the summation order of the products differs (as
# the MiniROAD tests)
TOL = dict(rtol=1e-4, atol=1e-5)
# three AdamW updates of lr 3e-3 on f32 gradients that differ by summation
# order (~1e-7 relative) keep the params within 1e-5 (as the OAD steps)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
L = 3  # anticipation_length

RAW = {
    "model": "MiniROADA", "task": "ANTICIPATION", "loss": "ANTICIPATION", "metric": "AP",
    "optimizer": "AdamW", "rgb_type": "rgb_kinetics_bninception",
    "flow_type": "flow_anet_resnet50", "num_classes": 5, "embedding_dim": 32,
    "hidden_dim": 16, "num_layers": 1, "dropout": 0.0, "lr": 3e-3, "weight_decay": 0.05,
    "window_size": 8, "batch_size": 4, "anticipation_length": L, "data_name": "SYNTH",
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


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "actionness"])
def models(request):
    raw = {**RAW, "actionness": request.param}
    jm = JaxMiniROADA(JaxConfig.from_dict(raw))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tm = MiniROADA(RecognitionConfig.from_dict(raw))
    return jm, jparams, tm, miniroad_from_numpy(jparams)


def test_registered_and_init_tree_like_jax(models):
    jm, jparams, tm, tparams = models
    assert MODELS.get("MiniROADA") is MiniROADA
    mine = to_numpy_tree(tm.init(make_generator(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for a, b in zip(jax.tree.leaves(to_numpy_tree(tparams)), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)  # the bridge carries every leaf, heads included


@pytest.mark.parametrize("flow_is_zero", [False, True])
def test_forward_full_matches_jax(models, flow_is_zero):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(1)
    B, T = 3, 21
    rgb = rng.normal(0, 1, (B, T, tm.rgb_dim)).astype(np.float32)
    flow = (np.zeros((B, T, tm.flow_dim)) if flow_is_zero
            else rng.normal(0, 1, (B, T, tm.flow_dim))).astype(np.float32)
    for softmax in (True, False):
        want = jm.forward_full(jparams, rgb, flow, flow_is_zero=flow_is_zero, softmax=softmax)
        got = tm.forward_full(tparams, t(rgb), t(flow), flow_is_zero=flow_is_zero,
                              softmax=softmax)
        assert got[0].shape == (B, T, 5) and got[1].shape == (B, T, L, 5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(n(g), n(w), **TOL)


def test_forward_train_matches_jax(models):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(2)
    rgb = rng.normal(0, 1, (4, 8, tm.rgb_dim)).astype(np.float32)
    flow = np.zeros((4, 8, tm.flow_dim), np.float32)
    want = jm.forward_train(jparams, rgb, flow, jax.random.PRNGKey(0), flow_is_zero=True)
    got = tm.forward_train(tparams, t(rgb), None, None, flow_is_zero=True)
    assert got[0].shape == (4, 5) and got[1].shape == (4, L, 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    # the last frame of forward_full's logits is forward_train's
    full = tm.forward_full(tparams, t(rgb), None, flow_is_zero=True, softmax=False)
    np.testing.assert_allclose(n(full[1][:, -1]), n(got[1]), rtol=1e-6, atol=1e-6)


def test_the_kernels_plain_versions_stay_near_the_f32_scan(models):
    """backend 'pallas_train' runs K1 + K6's plain versions on the CPU: the
    bf16 stream (2^-9 relative a rounding) moves the logits by well under
    2^-5 of their size at these shapes."""
    _, _, tm, tparams = models
    rgb = t(np.random.default_rng(3).normal(0, 1, (4, 8, tm.rgb_dim)).astype(np.float32))
    want = tm.forward_train(tparams, rgb, None, None, flow_is_zero=True)
    got = tm.forward_train(tparams, rgb, None, None, flow_is_zero=True, backend="pallas_train")
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 2.0 ** -5 * float(w.abs().max())


def test_anticipation_mlce_matches():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, L, 5)).astype(np.float32)
    target = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (6, L))]
    target[2, 1] = 0.0  # an all-background row: the eps of the normalisation
    target[4, 0, 1] = 1.0  # two positives: normalised to 1/sqrt(2) each
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for v in (None, valid):
        want = jax_anticipation_mlce(jnp.asarray(logits), jnp.asarray(target),
                                     None if v is None else jnp.asarray(v))
        got = anticipation_mlce(t(logits), t(target), None if v is None else t(v))
        np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)


def _batches(num, seed=0):
    """num batches of 4 windows; the last is partial (one padding row)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        rgb = rng.normal(0, 1, (4, 8, 1024)).astype(np.float32)
        ant = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, L))]
        valid = np.array([1, 1, 1, 0 if i == num - 1 else 1], np.float32)
        out.append((rgb, ant, valid))
    return out


@pytest.mark.parametrize("schedule", [False, True])
def test_three_ant_train_steps_match_jax(schedule):
    """Dropout 0, the scan GRU on both sides; the last batch is partial."""
    jcfg, cfg = JaxConfig.from_dict(RAW), RecognitionConfig.from_dict(RAW)
    jm = JaxMiniROADA(jcfg)
    jparams = jm.init(jax.random.PRNGKey(11))
    jopt = jax_build_optimizer(jcfg, jax_schedule(RAW["lr"], 20) if schedule else None)
    jstep = jax_make_ant_train_step(jm, jopt, flow_is_zero=True)
    params = miniroad_from_numpy(jax.tree.map(np.asarray, jparams))
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    opt = build_optimizer(cfg, params)
    step = make_ant_train_step(MiniROADA(cfg), opt, flow_is_zero=True,
                               schedule=warmup_cosine_schedule(RAW["lr"], 20) if schedule else None)
    jstate, jlosses, losses = jopt.init(jparams), [], []
    for rgb, ant, valid in _batches(3):
        jparams, jstate, loss = jstep(jparams, jstate, jnp.asarray(rgb),
                                      jnp.zeros((4, 8, 2048), jnp.float32), jnp.asarray(ant),
                                      jnp.asarray(valid), jax.random.PRNGKey(0))
        jlosses.append(float(loss))
        losses.append(float(step(params, t(rgb), None, t(ant), t(valid), None)))
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    for g, w in zip(jax.tree.leaves(to_numpy_tree(params)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g, np.asarray(w), **STEP_TOL)
    assert update_count(opt) == 3


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ant")
    data_root, vl_path, _, _ = make_synth_dataset(
        str(root), num_train=2, num_test=2, num_classes=5, rgb_dim=1024, min_len=100,
        max_len=160, seed=4, rgb_type="rgb_kinetics_bninception",
    )
    cfg = {
        **RAW, "feature_pretrained": "synth", "root_path": data_root,
        "annotation_type": "target_perframe", "video_list_path": vl_path,
        "output_path": str(root / "out"), "window_size": 16, "batch_size": 8,
        "num_epoch": 2, "dropout": 0.1, "embedding_dim": 64, "hidden_dim": 48, "stride": 4,
    }
    path = root / "ant.yaml"
    path.write_text(yaml.dump(cfg))
    return root, path, cfg


def test_ant_evaluator_matches_jax(synth, models):
    _, _, cfg = synth
    jm, jparams, tm, tparams = models
    raw = {**cfg, "embedding_dim": 32, "hidden_dim": 16}
    kw = dict(root_path=cfg["root_path"], rgb_type=cfg["rgb_type"], flow_type=cfg["flow_type"],
              annotation_type="target_perframe", num_classes=5, training=False, window_size=16)
    jinfo = jax_load_dataset_info(cfg["video_list_path"], "SYNTH")
    info = load_dataset_info(cfg["video_list_path"], "SYNTH")
    jstore = jax_load_feature_store(vids=jinfo.test_session_set, **kw)
    store = load_feature_store(vids=info.test_session_set, **kw)
    want_map, want = JaxAntEvaluator(JaxConfig.from_dict(raw), jinfo.class_index)(jm, jparams,
                                                                                  jstore)
    got_map, got = AntEvaluator(RecognitionConfig.from_dict(raw), info.class_index)(
        tm, tparams, store)
    assert got_map == pytest.approx(want_map, abs=1e-6)
    assert set(want) == set(got)
    for key in ["mean_AP", "mean_anticipation_AP"]:
        assert got[key] == pytest.approx(want[key], abs=1e-6)
    for step in range(1, L + 1):
        w, g = want[f"anticipation_{step}"], got[f"anticipation_{step}"]
        assert g["mean_AP"] == pytest.approx(w["mean_AP"], abs=1e-6)
        for c, ap in w["per_class_AP"].items():
            assert g["per_class_AP"][c] == pytest.approx(ap, abs=1e-6)


def test_ant_train_cli_and_checkpoints_both_ways(synth, tmp_path):
    """--task ANTICIPATION trains (the mean anticipation mAP above the
    untrained model's), the JAX CLI evaluates its checkpoint to the port's
    mAP, and the port evaluates and resumes a JAX checkpoint."""
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
    model = MiniROADA(rcfg)
    untrained, _ = AntEvaluator(rcfg, info.class_index)(model, model.init(make_generator(20)),
                                                       store)
    assert best > untrained + 0.02
    ckpt, = (tmp_path / "out").glob("*/ckpts/best_*.ckpt")
    ev = ["--eval", str(ckpt), "--output_path", out]
    assert jax_train_main(["--config", str(cfg_path), *ev]) == pytest.approx(best, abs=1e-6)
    port_map, result = run_eval(RecognitionConfig.from_dict({**rcfg.to_dict(), "eval": str(ckpt)}),
                                "cpu")
    assert port_map == pytest.approx(best, abs=1e-6) and "anticipation_3" in result
    # a JAX checkpoint (params + optax state) in the port: its eval, then a resumed epoch
    jcfg = JaxConfig.from_dict(cfg)
    jm = JaxMiniROADA(jcfg)
    jparams = jm.init(jax.random.PRNGKey(5))
    jpath = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(jpath, jparams, jax_build_optimizer(jcfg).init(jparams), epoch=1,
                        rng=jax.random.PRNGKey(1))
    want = jax_train_main(["--config", str(cfg_path), "--eval", jpath, "--output_path", out])
    got, _ = run_eval(RecognitionConfig.from_dict({**rcfg.to_dict(), "eval": jpath}), "cpu")
    assert got == pytest.approx(want, abs=1e-6)
    resumed = run_train(RecognitionConfig.from_dict({**rcfg.to_dict(),
                                                     "output_path": str(tmp_path / "r")}),
                        "cpu", resume=jpath)
    assert len(resumed.epoch_losses) == 1 and resumed.stats["steps"] > 0
    if resumed.ckpt_path is not None:
        assert int(load_checkpoint(resumed.ckpt_path)["opt_state"][0]) == resumed.stats["steps"]
