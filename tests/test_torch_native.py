"""The port's native data engine on the CPU: the C++ mmap feature store
(built with g++ here, as on the card's host), the native recognition data
and window sampler against the port's numpy WindowSampler and against
prego_tpu.data.native_loader (bit for bit), the lazy evaluator on the
native store, the ring's reuse protocol with a host stand-in for the CUDA
event, and the train CLI on ``data_backend: native``."""

import numpy as np
import pytest
import torch
import yaml

from prego_tpu.cli.train import main as jax_train_main
from prego_tpu.data.native_loader import NativeRecognitionData as JaxNativeData
from prego_tpu.data.native_loader import NativeWindowSampler as JaxNativeSampler
from prego_tpu.native import build_native_library, native_available
from prego_tpu_torch.cli.train import run_eval, run_train
from prego_tpu_torch.core import RecognitionConfig, make_generator
from prego_tpu_torch.data import (
    NativeRecognitionData,
    NativeWindowSampler,
    WindowSampler,
    load_dataset_info,
    load_feature_store,
)
from prego_tpu_torch.data.native_loader import BatchRing
from prego_tpu_torch.models.miniroad import MiniROAD
from prego_tpu_torch.native import NativeFeatureStore, library_path
from prego_tpu_torch.native import store as native_store
from prego_tpu_torch.train import Evaluator
from tests.synth import make_synth_dataset

FLOW = "flow_kinetics_bninception"  # a real (not zeroed) 1024-wide flow stream


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small models: under pytest-xdist each
    worker otherwise starts a thread per core, and the oversubscribed
    threads cost far more than they save at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    arrays, paths = [], []
    for i, (t, d) in enumerate([(50, 32), (70, 32), (20, 32)]):
        a = rng.normal(0, 1, (t, d)).astype(np.float32)
        np.save(root / f"v{i}.npy", a)
        arrays.append(a)
        paths.append(str(root / f"v{i}.npy"))
    a64 = rng.normal(0, 1, (15, 32))  # float64 on disk: converted to f32
    np.save(root / "v64.npy", a64)
    arrays.append(a64.astype(np.float32))
    paths.append(str(root / "v64.npy"))
    return paths, arrays


def test_library_is_built_outside_the_package_by_hash(npy_files):
    NativeFeatureStore(npy_files[0][:1]).close()
    path = library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert not list(native_store.SOURCE.parent.glob("*.so"))  # nothing built in place
    assert not any("march" in f for f in native_store.CXX_FLAGS)  # loads on any host


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_store, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_store, "CXX_FLAGS", [*native_store.CXX_FLAGS, "-no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_store.build_library()


def test_open_dims_read(npy_files):
    paths, arrays = npy_files
    fs = NativeFeatureStore(paths)
    assert fs.ok.all()
    for i, a in enumerate(arrays):
        assert fs.dims(i) == a.shape
        np.testing.assert_array_equal(fs.read_all(i), a)
        np.testing.assert_array_equal(fs.read_rows(i, 3, 9), a[3:12])
    fs.close()


@pytest.mark.parametrize("given_out", [False, True])
def test_sync_and_async_gathers_equal_numpy_slicing(npy_files, given_out):
    paths, arrays = npy_files
    fs = NativeFeatureStore(paths, n_threads=3)
    rng = np.random.default_rng(1)
    W = 8
    vid_idx = rng.integers(0, len(arrays), 40).astype(np.int32)
    starts = np.array([int(rng.integers(0, arrays[v].shape[0] - W)) for v in vid_idx], np.int64)
    want = np.stack([arrays[v][s : s + W] for v, s in zip(vid_idx, starts)])
    outs = [torch.full((10, W, 32), float("nan")) if given_out else None for _ in range(4)]
    pend = [fs.gather_windows_async(vid_idx[i::4], starts[i::4], W, 32, out=outs[i])
            for i in range(4)]  # four gathers in flight at once
    sync = [fs.gather_windows(vid_idx[i::4], starts[i::4], W, 32) for i in range(4)]
    for i, (p, s) in enumerate(zip(pend, sync)):
        got = p.wait()
        if given_out:
            assert got is outs[i]  # written in place: the caller's buffer
        np.testing.assert_array_equal(got.numpy(), want[i::4])
        np.testing.assert_array_equal(s.numpy(), want[i::4])
    assert pend[0].wait() is pend[0].out  # wait() again returns the same buffer
    with pytest.raises(ValueError, match="contiguous float32 CPU tensor"):
        fs.gather_windows(vid_idx[:2], starts[:2], W, 32, out=torch.empty(2, W, 32).double())
    fs.close()


def test_out_of_range_rows_are_zero_filled(npy_files):
    paths, arrays = npy_files
    fs = NativeFeatureStore(paths)
    out = fs.gather_windows(np.array([0]), np.array([-5]), 8, 32)[0].numpy()
    assert np.all(out[:5] == 0)  # the training zero prefix: a negative start
    np.testing.assert_array_equal(out[5:], arrays[0][:3])
    assert np.all(fs.gather_windows(np.array([0]), np.array([-20]), 8, 32).numpy() == 0)
    out2 = fs.gather_windows(np.array([2]), np.array([18]), 8, 32)[0].numpy()
    np.testing.assert_array_equal(out2[:2], arrays[2][18:20])
    assert np.all(out2[2:] == 0)  # past the end
    assert np.all(fs.read_rows(2, 18, 5)[2:] == 0)
    fs.close()


def test_missing_file_flagged(npy_files, tmp_path):
    paths, _ = npy_files
    fs = NativeFeatureStore([paths[0], str(tmp_path / "nope.npy")])
    assert fs.ok.tolist() == [True, False]
    fs.close()


# ---- the recognition data and the sampler ----


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic recipe, with a real flow stream written beside the
    zeroed one's shape probe. The JAX package's native library is built as
    its own tests build it (in place)."""
    assert native_available() or build_native_library()
    root = tmp_path_factory.mktemp("torch_native")
    data_root, vl_path, train, test = make_synth_dataset(
        str(root), num_train=3, num_test=2, num_classes=6, rgb_dim=1024, flow_dim=2048,
        min_len=60, max_len=120, seed=9, rgb_type="rgb_kinetics_bninception",
    )
    rng = np.random.default_rng(3)
    for vid in train + test:
        T = np.load(f"{data_root}/target_perframe/{vid}.npy").shape[0]
        d = root / "SYNTH" / FLOW / "assembly_optical_flow_BNInception" / vid
        d.mkdir(parents=True)
        np.save(d / "assembling.npy", rng.normal(0, 1, (T, 1024)).astype(np.float32))
    return data_root, vl_path, train, test


def _kwargs(flow_type, training):
    return dict(rgb_type="rgb_kinetics_bninception", flow_type=flow_type,
                annotation_type="target_perframe", num_classes=6, training=training,
                window_size=16)


def _stores(synth, flow_type, training=True):
    data_root, vl_path, _, _ = synth
    info = load_dataset_info(vl_path, "SYNTH")
    vids = list(info.train_session_set if training else info.test_session_set)
    kw = _kwargs(flow_type, training)
    return (load_feature_store(data_root, vids, **kw), NativeRecognitionData(data_root, vids, **kw),
            JaxNativeData(data_root, vids, **kw))


@pytest.mark.parametrize("flow_type", ["flow_anet_resnet50", FLOW])
def test_lengths_and_lazy_columns_match_the_numpy_store(synth, flow_type):
    numpy_store, native, _ = _stores(synth, flow_type)
    assert native.vids == numpy_store.vids
    assert native.flow_is_zero == (flow_type == "flow_anet_resnet50")
    for v in numpy_store.vids:
        assert native.length(v) == numpy_store.length(v)  # the virtual prefix included
        for col in ("rgb", "flow", "target"):
            np.testing.assert_array_equal(np.asarray(getattr(native, col)[v]),
                                          getattr(numpy_store, col)[v])
            np.testing.assert_array_equal(getattr(native, col)[v][10:40],
                                          getattr(numpy_store, col)[v][10:40])


def _assert_batches_equal(a, b, tensors=True):
    conv = (lambda x: x.numpy()) if tensors else np.asarray
    np.testing.assert_array_equal(conv(b.rgb), a.rgb)
    np.testing.assert_array_equal(conv(b.flow), a.flow)
    np.testing.assert_array_equal(conv(b.target), a.target)
    np.testing.assert_array_equal(b.valid, a.valid)
    live = a.valid > 0  # a padding row's start: 0 in the numpy sampler, -(10**9) natively
    np.testing.assert_array_equal(b.starts[live], a.starts[live])
    assert b.vids == a.vids


@pytest.mark.parametrize("flow_type", ["flow_anet_resnet50", FLOW])
def test_native_batches_bit_equal_numpy_and_jax_native(synth, flow_type):
    """Window offsets, order and padding (the trailing batch's -(10**9)
    starts, zero-filled) equal the port's numpy WindowSampler's and the
    JAX package's native sampler's; the batches are equal bit for bit."""
    numpy_store, native, jax_native = _stores(synth, flow_type)
    samplers = (WindowSampler(numpy_store, 16, 4), NativeWindowSampler(native, 16, 4),
                JaxNativeSampler(jax_native, 16, 4))
    for s in samplers:
        s.resample(np.random.default_rng(5))
    assert samplers[0].windows == samplers[1].windows == samplers[2].windows
    assert len(samplers[0]) % 7  # a partial trailing batch
    n_batches = 0
    for epoch in range(2):  # the second epoch reuses the ring's buffers
        iters = [s.iter_batches(7, shuffle=True, rng=np.random.default_rng(7 + epoch))
                 for s in samplers]
        for want, got, jax_got in zip(*iters):
            _assert_batches_equal(want, got)
            _assert_batches_equal(want, jax_got, tensors=False)
            got.on_copied()
            n_batches += 1
    assert n_batches == 2 * samplers[0].num_batches(7)
    assert got.starts[-1] == -(10 ** 9) and got.valid[-1] == 0  # a padded trailing batch
    assert not got.rgb[-1].any() and not got.target[-1].any()
    assert samplers[1].ring.replaced == 0  # every slot was reused


def test_missing_video_dropped(synth):
    data_root, _, train, _ = synth
    data = NativeRecognitionData(data_root, list(train) + ["ghost_video"],
                                 **_kwargs("flow_anet_resnet50", True))
    assert data.removed == 1 and data.vids == list(train)


def test_native_store_drives_the_lazy_evaluator(synth):
    numpy_store, native, _ = _stores(synth, "flow_anet_resnet50", training=False)
    cfg = RecognitionConfig.from_dict({
        "rgb_type": "rgb_kinetics_bninception", "flow_type": "flow_anet_resnet50",
        "embedding_dim": 48, "hidden_dim": 32, "num_layers": 1, "num_classes": 6,
        "dropout": 0.0, "metric": "AP", "data_name": "SYNTH",
    })
    model = MiniROAD(cfg)
    params = model.init(make_generator(0))
    ev = Evaluator(cfg, [f"c{i}" for i in range(6)])
    mAP_np, r_np = ev(model, params, numpy_store, chunk_size=64)
    mAP_nat, r_nat = ev(model, params, native, chunk_size=64)
    assert mAP_nat == mAP_np and r_nat["output"] == r_np["output"]


# ---- the ring's reuse protocol ----


class DeferredCopy:
    """A stand-in for the CUDA event recorded after a non-blocking copy:
    the copy itself runs only when the ring waits on the event (or at the
    end), as a copy still in flight on the card would read the buffer late."""

    log = []

    def __init__(self, batch, copies):
        self.batch, self.copies, self.done = batch, copies, False

    def record(self, stream=None):
        DeferredCopy.log.append(("record", self.batch.index))

    def synchronize(self):
        if not self.done:
            b = self.batch
            self.copies[b.index] = (b.rgb.clone(), b.flow.clone(), b.target.clone())
            self.done = True
            DeferredCopy.log.append(("wait", self.batch.index))


def test_ring_waits_for_a_copy_in_flight_before_reusing_its_buffers(synth, monkeypatch):
    numpy_store, native, _ = _stores(synth, FLOW)
    copies, events, current = {}, [], {}

    def make_event():
        events.append(DeferredCopy(current["batch"], copies))
        return events[-1]

    sampler = NativeWindowSampler(native, 16, 4, make_event=make_event)
    real_gather, started = native.gather_async, []

    def gather_async(*args):
        DeferredCopy.log.append(("gather", len(started)))
        started.append(1)
        return real_gather(*args)

    monkeypatch.setattr(native, "gather_async", gather_async)
    DeferredCopy.log = []
    ref = WindowSampler(numpy_store, 16, 4)
    for s in (ref, sampler):
        s.resample(np.random.default_rng(1))
    wants = list(ref.iter_batches(4, rng=np.random.default_rng(2)))
    ptrs = []
    for i, batch in enumerate(sampler.iter_batches(4, rng=np.random.default_rng(2))):
        batch.index = i
        current["batch"] = batch
        ptrs.append(batch.rgb.data_ptr())
        batch.on_copied()  # the copy is "enqueued": it runs when the ring waits on it
    for e in events:
        e.synchronize()  # the copies still in flight at the end
    assert len(wants) == len(copies) > 6
    for i, want in enumerate(wants):
        np.testing.assert_array_equal(copies[i][0].numpy(), want.rgb)
        np.testing.assert_array_equal(copies[i][1].numpy(), want.flow)
        np.testing.assert_array_equal(copies[i][2].numpy(), want.target)
    assert len(set(ptrs)) == 3 and sampler.ring.replaced == 0  # three slots, reused
    # batch i's copy ran before the gather of batch i + 3 into its slot started
    for i in range(len(wants) - 3):
        assert DeferredCopy.log.index(("wait", i)) < DeferredCopy.log.index(("gather", i + 3))


def test_ring_gives_fresh_buffers_where_a_batch_was_never_marked(synth):
    numpy_store, native, _ = _stores(synth, "flow_anet_resnet50")
    ref, sampler = WindowSampler(numpy_store, 16, 4), NativeWindowSampler(native, 16, 4)
    for s in (ref, sampler):
        s.resample(np.random.default_rng(4))
    got = list(sampler.iter_batches(5, rng=np.random.default_rng(6)))  # none marked
    for want, batch in zip(ref.iter_batches(5, rng=np.random.default_rng(6)), got):
        _assert_batches_equal(want, batch)
    assert sampler.ring.replaced == len(got) - 3


def test_ring_depth_and_pinning():
    shapes = {"rgb": (2, 4, 8), "flow": None, "target": (2, 4, 3)}
    with pytest.raises(ValueError, match="at least 3"):
        BatchRing(2, shapes, pin=False)
    if not torch.cuda.is_available():  # pinning needs the card's driver: it raises, no fallback
        with pytest.raises(RuntimeError):
            BatchRing(3, shapes, pin=True)
    ring = BatchRing(4, shapes, pin=False)
    assert [tuple(ring.acquire(i)["rgb"].shape) for i in range(2)] == [(2, 4, 8)] * 2
    assert ring.acquire(2)["flow"] is None


# ---- the train CLI on the native backend ----


def test_train_cli_native_equals_numpy_and_jax_evaluates_it(synth, tmp_path):
    data_root, vl_path, _, _ = synth
    cfg = {
        "model": "MiniROAD", "data_name": "SYNTH", "task": "OAD", "loss": "NONUNIFORM",
        "metric": "AP", "optimizer": "AdamW", "feature_pretrained": "synth",
        "root_path": data_root, "rgb_type": "rgb_kinetics_bninception", "flow_type": FLOW,
        "annotation_type": "target_perframe", "video_list_path": vl_path,
        "window_size": 16, "batch_size": 8, "num_epoch": 2, "lr": 0.003, "weight_decay": 0.05,
        "dropout": 0.1, "num_classes": 6, "embedding_dim": 48, "hidden_dim": 32,
        "num_layers": 1, "stride": 4,
    }
    runs = {b: run_train(RecognitionConfig.from_dict(
        {**cfg, "data_backend": b, "output_path": str(tmp_path / b)}), "cpu")
        for b in ("numpy", "native")}
    # the same batches in the same order, the same dropout stream: equal on the CPU
    assert runs["native"].epoch_losses == runs["numpy"].epoch_losses
    assert runs["native"].epoch_mAPs == runs["numpy"].epoch_mAPs
    assert runs["native"].stats["windows"] == runs["numpy"].stats["windows"]
    ckpt = runs["native"].ckpt_path
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.dump({**cfg, "data_backend": "native"}))
    jax_map = jax_train_main(["--config", str(path), "--eval", ckpt, "--output_path",
                              str(tmp_path / "j"), "--eval_output_dir", str(tmp_path / "pj")])
    port_map, _ = run_eval(RecognitionConfig.from_dict(
        {**cfg, "data_backend": "native", "eval": ckpt, "output_path": str(tmp_path / "e"),
         "eval_output_dir": str(tmp_path / "pe")}), "cpu")
    assert jax_map == pytest.approx(port_map, abs=1e-6)
    assert port_map == pytest.approx(runs["native"].best_mAP, abs=1e-6)
    assert (tmp_path / "pj" / "output_miniROAD.json").read_text() == \
        (tmp_path / "pe" / "output_miniROAD.json").read_text()
