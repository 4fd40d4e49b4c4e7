"""MiniROAD parity: the port's forward_full, forward_step and streaming
evaluator against prego_tpu's, with the same parameters handed over
through the bridge and the same synthetic videos; plus the checkpoint
format both ways."""

import json
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from prego_tpu.checkpoint import load_params as jax_load_params
from prego_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from prego_tpu.cli.schema_check import check_perframe
from prego_tpu.core import RecognitionConfig as JaxConfig
from prego_tpu.data import load_dataset_info, load_feature_store
from prego_tpu.models.miniroad import MiniROAD as JaxMiniROAD
from prego_tpu.train import Evaluator as JaxEvaluator
from prego_tpu.train.evaluator import streaming_scores as jax_streaming_scores
from prego_tpu_torch.checkpoint import load_checkpoint, load_params, save_checkpoint
from prego_tpu_torch.checkpoint.bridge import miniroad_from_numpy, to_numpy_tree
from prego_tpu_torch.core import RecognitionConfig
from prego_tpu_torch.core.seed import make_generator
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.train.evaluator import Evaluator, streaming_scores
from tests.synth import make_synth_dataset
from tests.torch_parity import n, t

# f32 on both sides (embed, LayerNorm, GRU, classifier, softmax): only the
# summation order of the products differs
TOL = dict(rtol=1e-4, atol=1e-5)

RAW = {
    "rgb_type": "rgb_kinetics_bninception",  # 1024-dim keeps the test fast
    "flow_type": "flow_anet_resnet50",  # the structurally zero stream
    "embedding_dim": 48,
    "hidden_dim": 32,
    "num_layers": 1,
    "num_classes": 6,
    "dropout": 0.0,
    "metric": "AP",
    "data_name": "SYNTH",
}


@pytest.fixture(scope="module")
def models():
    jm = JaxMiniROAD(JaxConfig.from_dict(RAW))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tm = MiniROAD(RecognitionConfig.from_dict(RAW))
    return jm, jparams, tm, miniroad_from_numpy(jparams)


@pytest.mark.parametrize("flow_is_zero", [False, True])
def test_forward_full_matches_jax(models, flow_is_zero):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(1)
    B, T = 3, 21
    rgb = rng.normal(0, 1, (B, T, tm.rgb_dim)).astype(np.float32)
    flow = (np.zeros if flow_is_zero else lambda s: rng.normal(0, 1, s))(
        (B, T, tm.flow_dim)).astype(np.float32)
    want = jm.forward_full(jparams, rgb, flow, flow_is_zero=flow_is_zero)
    got = tm.forward_full(tparams, t(rgb), t(flow), flow_is_zero=flow_is_zero)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    logits = tm.forward_full(tparams, t(rgb), t(flow), flow_is_zero=flow_is_zero, softmax=False)
    want_logits = jm.forward_full(jparams, rgb, flow, flow_is_zero=flow_is_zero, softmax=False)
    np.testing.assert_allclose(n(logits), n(want_logits), **TOL)


def test_forward_step_matches_jax(models):
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(2)
    B, T = 2, 9
    rgb = rng.normal(0, 1, (B, T, tm.rgb_dim)).astype(np.float32)
    flow = np.zeros((B, T, tm.flow_dim), np.float32)
    jh, th = jm.init_hidden(B), tm.init_hidden(B)
    for i in range(T):
        js, jh = jm.forward_step(jparams, rgb[:, i], flow[:, i], jh, flow_is_zero=True)
        ts, th = tm.forward_step(tparams, t(rgb[:, i]), t(flow[:, i]), th, flow_is_zero=True)
        np.testing.assert_allclose(n(ts), n(js), **TOL)
        np.testing.assert_allclose(n(th[0]), n(jh[0]), **TOL)


def test_kernel_backend_bf16_stream_close_to_f32(models):
    """The K1 dtype walk (bf16 xg, W_hh and h operand) against the f32
    scan: scores move by at most a few bf16 ulps of the hidden state."""
    _, _, tm, tparams = models
    rng = np.random.default_rng(3)
    rgb = t(rng.normal(0, 1, (2, 40, tm.rgb_dim)).astype(np.float32))
    f32 = tm.forward_full(tparams, rgb, None, flow_is_zero=True)
    bf16 = tm.forward_full(tparams, rgb, None, flow_is_zero=True, backend="kernel")
    np.testing.assert_allclose(n(bf16), n(f32), rtol=0, atol=2e-2)


def test_streaming_scores_padded_batch_matches_jax(models):
    """The padded-batch streamer: 50 frames in 16-frame chunks, so the
    state crosses three chunk boundaries and the last chunk is short."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(4)
    rgb = rng.normal(0, 1, (3, 50, tm.rgb_dim)).astype(np.float32)
    flow = np.zeros((3, 50, tm.flow_dim), np.float32)
    want = jax_streaming_scores(jm, jparams, rgb, flow, True, chunk_size=16)
    got = streaming_scores(tm, tparams, rgb, flow, True, chunk_size=16)
    assert got.shape == want.shape == (3, 50, RAW["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_eval")
    data_root, vl_path, _, _ = make_synth_dataset(
        str(root), num_train=1, num_test=5, num_classes=6, rgb_dim=1024,
        min_len=80, max_len=300, seed=3, rgb_type="rgb_kinetics_bninception",
    )
    info = load_dataset_info(vl_path, "SYNTH")
    return load_feature_store(
        data_root, info.test_session_set, RAW["rgb_type"], RAW["flow_type"],
        "target_perframe", 6, training=False, window_size=16,
    )


def test_streaming_evaluator_matches_jax(models, store, tmp_path):
    """Groups of 2 videos, 96-frame chunks: the state crosses chunk
    boundaries and videos of different lengths share a batch."""
    jm, jparams, tm, tparams = models
    names = [f"c{i}" for i in range(6)]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jmap, jres = JaxEvaluator(JaxConfig.from_dict(RAW), names)(
        jm, jparams, store, export_json=str(jpath), chunk_size=96, video_batch=2)
    tmap, tres = Evaluator(RecognitionConfig.from_dict(RAW), names)(
        tm, tparams, store, export_json=str(tpath), chunk_size=96, video_batch=2)
    np.testing.assert_allclose(tmap, jmap, rtol=1e-4)
    jout, tout = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    check_perframe(tout)
    assert tout == jout  # equal per-frame argmax and gt for every video
    assert tres["fps"] > 0


def test_checkpoint_format_both_ways(models, tmp_path):
    jm, jparams, tm, tparams = models
    opt = optax.adamw(1e-3)
    path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(str(path), jparams, opt.init(jparams), epoch=3,
                        rng=jax.random.PRNGKey(1))
    ck = load_checkpoint(str(path))  # optax classes become inert stubs
    assert ck["epoch"] == 3 and ck["opt_state"] is not None
    for a, b in zip(jax.tree.leaves(ck["params"]), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)

    path2 = tmp_path / "torch.ckpt"
    save_checkpoint(str(path2), tparams, epoch=1)
    back = jax_load_params(str(path2))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(load_params(str(path2))))


def test_restricted_loader_runs_no_foreign_code(tmp_path, capsys):
    class Boom:
        def __reduce__(self):
            return (print, ("side effect",))

    path = tmp_path / "evil.ckpt"
    path.write_bytes(pickle.dumps({"params": {"w": np.ones(2)}, "x": Boom()}))
    ck = load_checkpoint(str(path))
    assert "side effect" not in capsys.readouterr().out  # print was stubbed
    assert ck["x"].qualified_name == "builtins.print"
    np.testing.assert_array_equal(ck["params"]["w"], np.ones(2))


def test_bridge_round_trip_and_init_distribution(models):
    _, jparams, tm, tparams = models
    back = to_numpy_tree(tparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        miniroad_from_numpy({**jparams, "extra": np.zeros(1)})
    own = tm.init(make_generator(0))
    for key in ("embed", "cls"):
        assert own[key]["w"].shape == tparams[key]["w"].shape
        bound = 1 / own[key]["w"].shape[0] ** 0.5
        assert float(own[key]["w"].abs().max()) <= bound
    g = own["gru"][0]
    assert float(g["w_hh"].abs().max()) <= 1 / tm.hidden_dim ** 0.5
    assert torch.equal(own["ln"]["scale"], torch.ones(tm.embedding_dim))
