"""The port's own copies of the JAX package's numpy modules (data,
aggregation, metrics) against the originals, on the same inputs: the
copies must give equal results, bit for bit."""

import numpy as np
import pytest

from prego_tpu import aggregate as jax_aggregate
from prego_tpu import data as jax_data
from prego_tpu.metrics import mistake as jax_mistake
from prego_tpu.metrics import perframe as jax_perframe
from prego_tpu.metrics import postprocessing as jax_post
from prego_tpu_torch import aggregate
from prego_tpu_torch import data
from prego_tpu_torch.metrics import get_metrics, perframe_average_precision, perstage_average_precision
from prego_tpu_torch.metrics.postprocessing import thumos_postprocessing
from tests.synth import make_synth_dataset

WINDOW = 16


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    data_root, vl_path, train, test = make_synth_dataset(
        str(root), num_train=3, num_test=2, num_classes=6, rgb_dim=1024, min_len=90,
        max_len=170, seed=8, rgb_type="rgb_kinetics_bninception",
    )
    kw = dict(root_path=data_root, rgb_type="rgb_kinetics_bninception",
              flow_type="flow_anet_resnet50", annotation_type="target_perframe",
              num_classes=6, window_size=WINDOW)
    return vl_path, train, test, kw


def _same_store(a, b):
    assert a.vids == b.vids and a.flow_is_zero == b.flow_is_zero and a.removed == b.removed
    assert (a.rgb_dim, a.flow_dim, a.num_classes) == (b.rgb_dim, b.flow_dim, b.num_classes)
    for v in a.vids:
        for name in ("rgb", "flow", "target"):
            np.testing.assert_array_equal(getattr(a, name)[v], getattr(b, name)[v])


@pytest.mark.parametrize("training", [True, False])
def test_feature_store_and_video_list_match(synth, training):
    vl_path, train, test, kw = synth
    info, jinfo = data.load_dataset_info(vl_path, "SYNTH"), jax_data.load_dataset_info(vl_path, "SYNTH")
    assert info.class_index == jinfo.class_index
    assert (info.train_session_set, info.test_session_set) == (jinfo.train_session_set, jinfo.test_session_set)
    vids = (train if training else test) + ["missing_video"]  # a dropped video counts in both
    _same_store(data.load_feature_store(vids=vids, training=training, **kw),
                jax_data.load_feature_store(vids=vids, training=training, **kw))


def test_window_sampler_gives_the_same_windows_and_batches(synth):
    _, train, _, kw = synth
    store = data.load_feature_store(vids=train, training=True, **kw)
    jstore = jax_data.load_feature_store(vids=train, training=True, **kw)
    sampler, jsampler = data.WindowSampler(store, WINDOW, 4), jax_data.WindowSampler(jstore, WINDOW, 4)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):  # two epochs: resample, then a shuffled walk
        sampler.resample(rng)
        jsampler.resample(jrng)
        assert sampler.windows == jsampler.windows
        assert sampler.num_batches(7) == jsampler.num_batches(7)
        batches = list(sampler.iter_batches(7, shuffle=True, rng=rng))
        jbatches = list(jsampler.iter_batches(7, shuffle=True, rng=jrng))
        assert len(batches) == len(jbatches)
        for b, jb in zip(batches, jbatches):
            for name in ("rgb", "flow", "target", "valid", "starts", "ends"):
                np.testing.assert_array_equal(getattr(b, name), getattr(jb, name))
            assert b.vids == jb.vids
        assert batches[-1].valid.sum() < 7 or len(sampler) % 7 == 0  # the padded partial batch


def test_pack_eval_batch_matches(synth):
    _, _, test, kw = synth
    store = data.load_feature_store(vids=test, training=False, **kw)
    jstore = jax_data.load_feature_store(vids=test, training=False, **kw)
    got, want = data.pack_eval_batch(store, pad_to=200), jax_data.pack_eval_batch(jstore, pad_to=200)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


def test_aggregate_matches():
    rng = np.random.default_rng(2)
    raw = {}
    for i in range(4):
        T = int(rng.integers(150, 900))
        gt = np.repeat(rng.integers(0, 9, T // 30 + 1), 30)[:T]
        pred = np.where(rng.random(T) < 0.8, gt, rng.integers(0, 9, T))
        raw[f"v{i}"] = {"pred": pred.tolist(), "gt": gt.tolist()}
    raw["empty"] = {"pred": [], "gt": []}
    assert aggregate.aggregate(raw) == jax_aggregate.aggregate(raw)


@pytest.mark.parametrize("metric", ["AP", "cAP"])
def test_perframe_metrics_match(metric):
    rng = np.random.default_rng(3)
    K = 7
    gt = np.eye(K, dtype=np.float32)[rng.integers(0, K, 600)]
    scores = rng.random((600, K)).astype(np.float32)
    scores[:, 3] = gt[:, 3] * 0.5 + scores[:, 3] * 0.5  # one learnable class
    names = [f"c{k}" for k in range(K)]
    got = perframe_average_precision(scores, gt, names, None, metric)
    want = jax_perframe.perframe_average_precision(scores, gt, names, None, metric)
    assert got == want
    assert perstage_average_precision(scores, gt, names, None, metric) == \
        jax_perframe.perstage_average_precision(scores, gt, names, None, metric)


def test_thumos_postprocessing_matches():
    rng = np.random.default_rng(4)
    gt = np.eye(22, dtype=np.float32)[rng.integers(0, 22, 64)]
    scores = rng.random((64, 22)).astype(np.float32)
    for smooth, switch in ((False, False), (True, True)):
        got = thumos_postprocessing(gt.copy(), scores.copy(), smooth=smooth, switch=switch)
        want = jax_post.thumos_postprocessing(gt.copy(), scores.copy(), smooth=smooth, switch=switch)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_mistake_metrics_match():
    rng = np.random.default_rng(6)
    gts, preds = {}, {}
    for i in range(5):
        L = int(rng.integers(2, 12))
        gts[f"v{i}"] = rng.integers(0, 6, L).tolist()
        preds[f"v{i}"] = [set(rng.integers(0, 6, 2).tolist()) for _ in range(L)]
    assert get_metrics(preds, gts) == jax_mistake.get_metrics(preds, gts)
