"""Recognition training, port against prego_tpu on the CPU: the loss, the
warmup-cosine schedule, dropout, three AdamW train steps, checkpoint
resume in both directions, and the train CLI end to end on synthetic
data. Inputs are made with numpy from a seed and handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from prego_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from prego_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from prego_tpu.cli.train import main as jax_train_main
from prego_tpu.core import RecognitionConfig as JaxConfig
from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
from prego_tpu.train import build_optimizer as jax_build_optimizer
from prego_tpu.train import make_train_step as jax_make_train_step
from prego_tpu.train.loss import last_frame_mlce as jax_last_frame_mlce
from prego_tpu.train.lr_schedule import warmup_cosine_schedule as jax_schedule
from prego_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from prego_tpu_torch.checkpoint.bridge import (
    adam_from_optax,
    adam_to_optax,
    miniroad_from_numpy,
    to_numpy_tree,
)
from prego_tpu_torch.cli.train import main as train_main
from prego_tpu_torch.cli.train import run_eval, run_train
from prego_tpu_torch.core import RecognitionConfig, make_generator
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.train import (
    Evaluator,
    build_optimizer,
    last_frame_mlce,
    make_train_step,
    update_count,
    warmup_cosine_schedule,
)
from tests.synth import make_synth_dataset
from tests.torch_parity import n, t

# f32 on both sides, the same update rule to rounding: the gradients differ
# by summation order (~1e-7 relative); Adam divides each by its own root
# mean square, and three updates of lr 3e-3 keep the params within 1e-5
STEP_TOL = dict(rtol=1e-5, atol=1e-5)

CFG = {
    "model": "MiniROAD", "task": "OAD", "loss": "NONUNIFORM", "metric": "AP",
    "optimizer": "AdamW", "rgb_type": "rgb_kinetics_bninception",
    "flow_type": "flow_anet_resnet50", "num_classes": 5, "embedding_dim": 32,
    "hidden_dim": 16, "num_layers": 1, "dropout": 0.0, "lr": 3e-3, "weight_decay": 0.05,
    "window_size": 8, "batch_size": 4,
}


def test_last_frame_mlce_matches():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (6, 5)).astype(np.float32)
    target = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 6)]
    target[2] = 0.0  # an all-background row: the eps of the normalisation
    target[4, 1] = 1.0  # two positives: normalised to 1/sqrt(2) each
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    for v in (None, valid):
        want = jax_last_frame_mlce(jnp.asarray(logits), jnp.asarray(target),
                                   None if v is None else jnp.asarray(v))
        got = last_frame_mlce(t(logits), t(target), None if v is None else t(v))
        np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("total", [2000, 300])
def test_warmup_cosine_schedule_matches(total):
    want, got = jax_schedule(1e-4, total), warmup_cosine_schedule(1e-4, total)
    for step in (0, 1, 299, 499, 500, total - 1, total):
        # the JAX schedule evaluates in f32: equal to its rounding, which near
        # the end (1 + cos close to 0) is an f32 ulp of 1, times base_lr
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-7 * 1e-4,
                                   err_msg=str(step))
    assert got(0) == pytest.approx(1e-7)  # base_lr x warmup_factor at the first update


def test_dropout_mask_from_the_generator():
    model = MiniROAD(RecognitionConfig.from_dict({**CFG, "dropout": 0.25}))
    params = model.init(make_generator(0))
    rgb = t(np.random.default_rng(1).normal(0, 1, (8, 32, 1024)).astype(np.float32))
    plain = model._embed(params, rgb, None, flow_is_zero=True)
    a = model._embed(params, rgb, None, flow_is_zero=True, generator=make_generator(7))
    b = model._embed(params, rgb, None, flow_is_zero=True, generator=make_generator(7))
    assert torch.equal(a, b)  # the same seed gives the same mask
    live = plain > 0
    kept = (a > 0) & live
    share = float(kept.sum()) / float(live.sum())
    assert abs(share - 0.75) < 0.01  # the keep share (binomial sd ~0.002 here)
    torch.testing.assert_close(a[kept], plain[kept] / 0.75, rtol=1e-6, atol=0)
    assert torch.all(a[live & ~kept] == 0)
    with pytest.raises(ValueError, match="generator"):
        model.forward_train(params, rgb, None, None, flow_is_zero=True)


def _batches(num, seed=0):
    """num batches of 4 windows; the last is partial (one padding row)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        rgb = rng.normal(0, 1, (4, 8, 1024)).astype(np.float32)
        target = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
        valid = np.array([1, 1, 1, 0 if i == num - 1 else 1], np.float32)
        out.append((rgb, target, valid))
    return out


def _jax_side(cfg, schedule):
    jcfg = JaxConfig.from_dict(cfg)
    model = JaxMiniROAD(jcfg)
    params = model.init(jax.random.PRNGKey(11))
    opt = jax_build_optimizer(jcfg, jax_schedule(cfg["lr"], 20) if schedule else None)
    step = jax_make_train_step(model, opt, flow_is_zero=True)
    return params, opt, step


def _jax_steps(step, params, opt_state, batches):
    losses = []
    for rgb, target, valid in batches:
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(rgb), jnp.zeros((4, 8, 2048), jnp.float32),
            jnp.asarray(target), jnp.asarray(valid), jax.random.PRNGKey(0),
        )
        losses.append(float(loss))
    return params, opt_state, losses


def _torch_side(cfg, host_params, schedule):
    model = MiniROAD(RecognitionConfig.from_dict(cfg))
    params = miniroad_from_numpy(host_params)
    for leaf in jax.tree.leaves(params):
        leaf.requires_grad_(True)
    opt = build_optimizer(RecognitionConfig.from_dict(cfg), params)
    step = make_train_step(model, opt, flow_is_zero=True,
                           schedule=warmup_cosine_schedule(cfg["lr"], 20) if schedule else None)
    return params, opt, step


def _torch_steps(step, params, batches):
    return [float(step(params, t(rgb), None, t(target), t(valid), None)) for rgb, target, valid in batches]


def _assert_params_close(torch_params, jax_params):
    got, want = to_numpy_tree(torch_params), jax.tree.map(np.asarray, jax_params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **STEP_TOL)


@pytest.mark.parametrize("schedule", [False, True])
def test_three_train_steps_match_jax(schedule):
    """Dropout 0, the scan GRU on both sides; the last batch is partial."""
    batches = _batches(3)
    jparams, jopt, jstep = _jax_side(CFG, schedule)
    params, opt, step = _torch_side(CFG, jax.tree.map(np.asarray, jparams), schedule)
    jparams, _, jlosses = _jax_steps(jstep, jparams, jopt.init(jparams), batches)
    losses = _torch_steps(step, params, batches)
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    _assert_params_close(params, jparams)
    assert update_count(opt) == 3
    if schedule:  # the third update took schedule(2): optax's count before it
        assert opt.param_groups[0]["lr"] == warmup_cosine_schedule(CFG["lr"], 20)(2)


@pytest.mark.parametrize("schedule", [False, True])
def test_port_checkpoint_resumes_in_jax(tmp_path, schedule):
    """Two port steps, saved; prego_tpu's trainer resumes it the way its CLI
    does (jax.tree.unflatten of the leaves) and takes JAX's third step."""
    batches = _batches(3)
    jparams0, jopt, jstep = _jax_side(CFG, schedule)
    params, opt, step = _torch_side(CFG, jax.tree.map(np.asarray, jparams0), schedule)
    _torch_steps(step, params, batches[:2])
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, params, adam_to_optax(opt, params, schedule), epoch=1)

    ckpt = jax_load_checkpoint(path)
    template = jopt.init(jparams0)
    opt_state = jax.tree.unflatten(jax.tree.structure(template), jax.tree.leaves(ckpt["opt_state"]))
    resumed, _, loss3 = _jax_steps(jstep, ckpt["params"], opt_state, batches[2:])
    want, _, want_losses = _jax_steps(jstep, jparams0, jopt.init(jparams0), batches)
    np.testing.assert_allclose(loss3, want_losses[2:], **STEP_TOL)
    for g, w in zip(jax.tree.leaves(resumed), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **STEP_TOL)


@pytest.mark.parametrize("schedule", [False, True])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, schedule):
    """Two JAX steps, saved with optax's state; the port reads it into
    AdamW's state and takes its own third step."""
    batches = _batches(3)
    jparams0, jopt, jstep = _jax_side(CFG, schedule)
    host0 = jax.tree.map(np.asarray, jparams0)
    jparams, jstate, _ = _jax_steps(jstep, jparams0, jopt.init(jparams0), batches[:2])
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, jparams, jstate, epoch=1, rng=jax.random.PRNGKey(1))

    ckpt = load_checkpoint(path)  # optax classes load as stubs
    params, opt, step = _torch_side(CFG, ckpt["params"], schedule)
    assert adam_from_optax(opt, params, ckpt["opt_state"]) == 2
    loss3 = _torch_steps(step, params, batches[2:])
    want, opt_w, step_w = _torch_side(CFG, host0, schedule)
    want_losses = _torch_steps(step_w, want, batches)
    np.testing.assert_allclose(loss3, want_losses[2:], **STEP_TOL)
    for g, w in zip(jax.tree.leaves(to_numpy_tree(params)), jax.tree.leaves(to_numpy_tree(want))):
        np.testing.assert_allclose(g, w, **STEP_TOL)
    assert update_count(opt) == update_count(opt_w) == 3


@pytest.fixture(scope="module")
def synth_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    data_root, vl_path, _, _ = make_synth_dataset(
        str(root), num_train=2, num_test=2, num_classes=5, rgb_dim=1024, min_len=100,
        max_len=160, seed=4, rgb_type="rgb_kinetics_bninception",
    )
    cfg = {
        **CFG, "data_name": "SYNTH", "feature_pretrained": "synth", "root_path": data_root,
        "annotation_type": "target_perframe", "video_list_path": vl_path,
        "output_path": str(root / "out"), "window_size": 16, "batch_size": 8,
        "num_epoch": 3, "dropout": 0.1, "embedding_dim": 64, "hidden_dim": 48, "stride": 4,
    }
    path = root / "synth.yaml"
    path.write_text(yaml.dump(cfg))
    return root, path, cfg


def test_train_cli_trains_and_jax_evaluates_its_checkpoint(synth_cfg, tmp_path):
    root, cfg_path, cfg = synth_cfg
    out = str(tmp_path / "out")
    best = train_main(["--config", str(cfg_path), "--device", "cpu", "--output_path", out])
    rcfg = RecognitionConfig.from_dict({**cfg, "output_path": out})
    from prego_tpu_torch.data import load_dataset_info, load_feature_store

    info = load_dataset_info(cfg["video_list_path"], "SYNTH")
    store = load_feature_store(
        root_path=cfg["root_path"], vids=info.test_session_set, rgb_type=cfg["rgb_type"],
        flow_type=cfg["flow_type"], annotation_type="target_perframe", num_classes=5,
        training=False, window_size=16,
    )
    model = MiniROAD(rcfg)
    untrained, _ = Evaluator(rcfg, info.class_index)(model, model.init(make_generator(rcfg.seed)), store)
    assert best > untrained + 0.05
    ckpts = sorted((tmp_path / "out").glob("*/ckpts/*.ckpt"))
    assert [c.name for c in ckpts] == [f"best_{best * 100:.2f}.ckpt"]  # saved, then renamed
    # the JAX package evaluates the port's checkpoint to the port's own mAP
    ev = ["--eval", str(ckpts[0]), "--eval_output_dir", str(tmp_path)]
    jax_map = jax_train_main(["--config", str(cfg_path), *ev, "--output_path", out])
    port_map, _ = run_eval(RecognitionConfig.from_dict(
        {**rcfg.to_dict(), "eval": str(ckpts[0]), "eval_output_dir": str(tmp_path)}), "cpu")
    assert jax_map == pytest.approx(port_map, abs=1e-6)
    assert port_map == pytest.approx(best, abs=1e-6)


def test_train_cli_resumes_its_own_checkpoint(synth_cfg, tmp_path):
    _, _, cfg = synth_cfg
    cfg = RecognitionConfig.from_dict({**cfg, "num_epoch": 1, "output_path": str(tmp_path / "a"),
                                       "lr_scheduler": True})
    first = run_train(cfg, "cpu")
    assert first.ckpt_path is not None and first.stats["steps"] > 0
    cfg.num_epoch, cfg.output_path = 2, str(tmp_path / "b")
    second = run_train(cfg, "cpu", resume=first.ckpt_path)
    assert len(second.epoch_losses) == 1  # epoch 2 only
    ckpt = load_checkpoint(second.ckpt_path)
    n_steps = first.stats["steps"] + second.stats["steps"]
    assert int(ckpt["opt_state"][0]) == n_steps == int(ckpt["opt_state"][3])
    assert ckpt["rng"] is None and ckpt["extra"]["torch_rng_device"] == "cpu"


def test_train_cli_runs_on_the_card_unless_asked(synth_cfg, monkeypatch):
    _, cfg_path, _ = synth_cfg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(["--config", str(cfg_path)])


def test_train_cli_refuses_what_is_not_ported(synth_cfg):
    """What the port still refuses, as the JAX package does: ANTICIPATION
    training on the native data backend (prego_tpu/cli/train.py:130-131)."""
    _, cfg_path, _ = synth_cfg
    ant = ["--model", "MiniROADA", "--task", "ANTICIPATION", "--loss", "ANTICIPATION",
           "--anticipation_length", "3", "--data_backend", "native"]
    with pytest.raises(SystemExit, match="numpy data backend") as port:
        train_main(["--config", str(cfg_path), "--device", "cpu", *ant])
    with pytest.raises(SystemExit, match="numpy data backend") as jax_side:
        jax_train_main(["--config", str(cfg_path), *ant])
    assert str(port.value) == str(jax_side.value)
