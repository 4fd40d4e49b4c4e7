"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no jax, so it runs on a machine that has only PyTorch:

  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest`` because tests/conftest.py sets up jax for the parity
tests.) Inputs are made with numpy from a seed and compared in bf16, the
kernels' working type.
"""

import ctypes
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prego_tpu_torch.ops import decode_attention as da
from prego_tpu_torch.ops import decode_attention_q8 as da8
from prego_tpu_torch.ops import decode_attention_wo as dwo
from prego_tpu_torch.ops import fused_dense as fd
from prego_tpu_torch.ops import fused_ffn as ffn
from prego_tpu_torch.ops import gru_cuda, gru_cuda_vjp, quant

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # decided at run time, inside the test: skip where there is no card
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


# GRU: identical bf16 roundings except where an f32 sum of H products,
# taken in another order, straddles a bf16 boundary of h: one bf16 ulp
# (2^-8 relative, |h| < 1) carried on by the recurrence
GRU_TOL = dict(rtol=0, atol=2.0 ** -6)
# GRU backward: r depends only on h_prev and xg, so it differs by the
# f32 summation order of h_prev.W_hh, at most one bf16 ulp (2^-8, r < 1).
# dxg and dh carry the dh chain: where an f32 sum straddles a bf16 boundary
# of dHG = [da, db, dc r], one bf16 ulp of dHG (2^-8 relative) enters dh and
# the chain carries it on, contracted by z and W_hh each frame; measured
# against the largest value, 2^-6 bounds it over these T
GRU_BWD_R_TOL = 2.0 ** -7
GRU_BWD_REL_TOL = 2.0 ** -6
# decode attention: p is rounded to bf16 against the split's own max, not
# the row's; each p_t moves by at most 2^-9 relative, the output (a convex
# combination of |v| < 5) by 2^-9 * 5, plus its own bf16 rounding
ATTN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -6)
# fused FFN: the bf16 output rounds h + y; sums of F products in another
# order can round one bf16 ulp apart, 2^-5 at |out| < 8
FFN_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -5)


def _gru_inputs(device, T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    xg = torch.from_numpy(rng.normal(0, 1, (T, B, 3 * H)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(0, 0.5, (B, H)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(-k, k, (H, 3 * H)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-k, k, (3 * H,)).astype(np.float32))
    return (xg.to(device, torch.bfloat16), h0.to(device), w.to(device, torch.bfloat16),
            b.to(device))


@pytest.mark.parametrize("T,B,H", [(1, 1, 16), (9, 3, 48), (40, 17, 256), (5, 100, 64),
                                   (64, 64, 1024)])
def test_gru_kernel_matches_plain(cuda_device, T, B, H):
    xg, h0, w, b = _gru_inputs(cuda_device, T, B, H)
    before = gru_cuda.KERNEL.launches
    hs, hT = gru_cuda.gru_recurrence(xg, h0, w, b)
    torch.cuda.synchronize()
    assert gru_cuda.KERNEL.launches == before + 1
    want_hs, want_hT = gru_cuda.gru_recurrence_reference(xg, h0, w, b)
    torch.testing.assert_close(hs.float(), want_hs.float(), **GRU_TOL)
    torch.testing.assert_close(hT, want_hT, **GRU_TOL)


@pytest.mark.parametrize("H", [16, 48, 1024])
@pytest.mark.parametrize("T", [0, 1, 128])
@pytest.mark.parametrize("B", [1, 16, 17, 64, 100])
def test_gru_kernel_at_its_edges(cuda_device, B, T, H):
    """K1 with no frame (hT is h0), one frame and 128; one row, B 17 (a
    ragged row tile) and B 100 (two tiles of rows a frame); H 16 and 48
    (clusters of 2) and 1024 (128 CTAs). hT is the last frame's state, a
    second call gives the same bits, and the workspace's counter is zero."""
    xg, h0, w, b = _gru_inputs(cuda_device, T, B, H, seed=B + T + H)
    hs, hT = gru_cuda.gru_recurrence(xg, h0, w, b)
    torch.cuda.synchronize()
    assert hs.shape == (T, B, H) and hT.shape == (B, H)
    want_hs, want_hT = gru_cuda.gru_recurrence_reference(xg, h0, w, b)
    torch.testing.assert_close(hs.float(), want_hs.float(), **GRU_TOL)
    torch.testing.assert_close(hT, want_hT, **GRU_TOL)
    if T:
        assert torch.equal(hT.to(torch.bfloat16), hs[-1])
    else:
        assert torch.equal(hT, h0)
    again = gru_cuda.gru_recurrence(xg, h0, w, b)
    assert torch.equal(again[0], hs) and torch.equal(again[1], hT)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    _, counter = gru_cuda.WORKSPACE.held[(cuda_device.index, stream)][0]
    assert int(counter.abs().sum()) == 0


def _attn_inputs(device, B, KV, R, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(
        device, torch.bfloat16)
    return mk(B, KV, R, hd), mk(B, KV, T, hd), mk(B, KV, T, hd)


@pytest.mark.parametrize("B,KV,R,T,hd", [(2, 2, 1, 128, 128), (3, 4, 2, 192, 64),
                                         (8, 32, 1, 512, 128), (2, 8, 4, 512, 128),
                                         (4, 4, 1, 4096, 128), (4, 2, 4, 200, 64),
                                         (4, 2, 8, 256, 256), (4, 8, 8, 4096, 64),
                                         (4, 3, 3, 100, 48), (4, 2, 1, 64, 16),
                                         (32, 32, 1, 512, 128)])
def test_decode_attention_kernel_matches_plain(cuda_device, B, KV, R, T, hd):
    """K2 over one cluster of up to 8 blocks per (row, kv head): T 4096
    (512 positions a block), T 200 and 100 (no multiple of 64 x C), bounds
    0, 1, T - 1 and T among them, R 1 to 8, hd 16 to 256; B 32 x 32 kv
    heads, where a (row, kv head) takes one block (clusters of one)."""
    q, k, v = _attn_inputs(cuda_device, B, KV, R, T, hd)
    valid = torch.tensor(([0, T, 1, T - 1, 77, 64, 65, 300] * B)[:B], dtype=torch.int32,
                         device=cuda_device).clamp(max=T)
    before = da.KERNEL.launches
    out = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert da.KERNEL.launches == before + 1
    want = da.decode_attention_reference(q, k, v, valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_TOL)
    assert torch.all(out[valid == 0] == 0)
    # a scalar bound reaches the same kernel
    torch.testing.assert_close(
        da.decode_attention(q, k, v, T // 2).float(),
        da.decode_attention_reference(q, k, v, T // 2).float(), **ATTN_TOL)


def test_decode_attention_kernel_is_deterministic(cuda_device):
    """The cluster merge sums its ranks in rank order: the same bits in two calls."""
    q, k, v = _attn_inputs(cuda_device, 8, 8, 4, 1000, 128, seed=5)
    valid = torch.tensor([1000, 999, 513, 512, 511, 200, 1, 0], dtype=torch.int32,
                         device=cuda_device)
    first = da.decode_attention(q, k, v, valid)
    second = da.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k2_and_k4_launch_once_and_allocate_only_their_output(cuda_device):
    """One kernel and one allocation (the output) a call: K2, and K4's two
    paths (the cluster GEMV at M 1, the wgmma tiles at M 64), ten calls each
    under one profiler session."""
    q, k, v = _attn_inputs(cuda_device, 8, 32, 1, 512, 128)
    valid = torch.tensor([0, 512, 1, 77, 255, 256, 300, 511], dtype=torch.int32,
                         device=cuda_device)
    x1, w, s = _w8_inputs(cuda_device, 1, 4096, 12288)
    x64, _, _ = _w8_inputs(cuda_device, 64, 4096, 12288)
    fns = (lambda: da.decode_attention(q, k, v, valid), lambda: quant.int8_matmul(x1, w, s),
           lambda: quant.int8_matmul(x64, w, s))
    for fn in fns:  # built and warm
        fn()
    torch.cuda.synchronize()
    for fn in fns:
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(10):
            fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in fns:
            for _ in range(10):
                fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {n: names.count(n) for n in set(names)}
    assert sorted(counts.values()) == [10, 10, 10], counts  # three kernels, nothing else


def _graph_node_types(fn, device):
    """The node types of a CUDA graph that captures one call of ``fn`` (0 a
    kernel, 2 a memset, ...): an exact count of what the call launches. The
    call runs once on the capture stream first, so that its workspaces for
    that stream exist before the capture."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


def test_k3_and_k5_allocate_only_their_output(cuda_device):
    """One allocation (the output) a call once the workspaces are as large
    as the calls need, and exactly their own kernels, nothing else, counted
    as the nodes of a captured call: K3 at the 7B shape with chip_smoke.py's
    bounds (its two passes), K5's streaming path at M 1 and 8 and its wgmma
    tiles at M 64 (one kernel each)."""
    args = _attn_q8_inputs(cuda_device, 8, 32, 1, 512, 128)
    valid = torch.tensor([0, 512, 1, 77, 255, 256, 300, 511], dtype=torch.int32,
                         device=cuda_device)
    w8a8 = [_w8a8_inputs(cuda_device, M, 4096, 12288) for M in (1, 8, 64)]
    fns = ((lambda: da8.decode_attention_q8(*args, valid), 2),
           *((lambda a=a: quant.int8xint8_matmul(*a), 1) for a in w8a8))
    for fn, _ in fns:  # built, warm, and their workspaces made
        fn()
    torch.cuda.synchronize()
    for fn, kernels in fns:
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(10):
            fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10
        assert _graph_node_types(fn, cuda_device) == [0] * kernels


def _ffn_inputs(device, M, D, F, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, *shape: torch.from_numpy(
        (rng.normal(0, 1, shape) * s).astype(np.float32)).to(device, torch.bfloat16)
    return (mk(1.0, M, D), mk(0.1, D) + 1, mk(D ** -0.5, D, 2 * F), mk(F ** -0.5, F, D))


@pytest.mark.parametrize("M,D,F", [(1, 64, 176), (3, 256, 512), (8, 512, 1000),
                                   (1, 4096, 11008), (8, 4096, 11008),
                                   (12, 512, 1000),  # the first design, in calls of 8 rows
                                   (16, 2048, 5632)])  # the ring, one launch
def test_fused_ffn_kernel_matches_plain(cuda_device, M, D, F):
    h, nw, w13, w2 = _ffn_inputs(cuda_device, M, D, F)
    out = ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)
    torch.cuda.synchronize()
    want = ffn.fused_ffn_block_reference(h, nw, w13, w2, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), **FFN_TOL)


def test_kernels_refuse_what_they_cannot_take(cuda_device):
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 2, 60, 176)
    with pytest.raises(ValueError):
        ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)  # D not a multiple of 8
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 9, 64, 176)
    with pytest.raises(ValueError):
        ffn.fused_ffn_block(h.view(-1)[1:65].view(1, 64), nw, w13, w2, 1e-5)  # misaligned rows
    q, k, v = _attn_inputs(cuda_device, 1, 1, 1, 64, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q.float(), k.float(), v.float(), 3)  # f32 cache
    q, k, v = _attn_inputs(cuda_device, 1, 1, 9, 64, 64)
    with pytest.raises(ValueError):
        da.decode_attention(q, k, v, 3)  # R above 8
    q, k, v = _attn_inputs(cuda_device, 1, 1, 8, 48000, 16)
    with pytest.raises(RuntimeError):
        da.decode_attention(q, k, v, 3)  # 8 x 6000 f32 scores a block: past shared memory
    xg, h0, w, b = _gru_inputs(cuda_device, 2, 2, 16)
    with pytest.raises(ValueError):
        gru_cuda.gru_recurrence(xg, h0.to(torch.bfloat16), w, b)  # bf16 state
    xg, h0, w, b = _gru_inputs(cuda_device, 2, 2, 24)
    with pytest.raises(ValueError):
        gru_cuda.gru_recurrence(xg, h0, w, b)  # H not a multiple of 16


def _gru_bwd_inputs(device, T, B, H, seed=0):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    mk = lambda a: torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return (
        mk(rng.normal(0, 1, (T, B, 3 * H))),  # xg
        mk(rng.uniform(-0.9, 0.9, (T, B, H))),  # h_prev
        mk(rng.normal(0, 0.5, (T, B, H))),  # dhs
        mk(rng.uniform(-k, k, (H, 3 * H))),  # w_hh
        torch.from_numpy(rng.uniform(-k, k, (3 * H,)).astype(np.float32)).to(device),
    )


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("T,B,H", [(1, 1, 16), (9, 3, 48), (13, 17, 256), (7, 100, 64),
                                   (20, 64, 1024), (128, 16, 1024)])
def test_gru_bwd_kernel_matches_plain(cuda_device, T, B, H):
    args = _gru_bwd_inputs(cuda_device, T, B, H)
    before = gru_cuda_vjp.KERNEL.launches
    dxg, r, dh0 = gru_cuda_vjp.gru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_cuda_vjp.KERNEL.launches == before + 1
    assert dxg.dtype == r.dtype == torch.bfloat16 and dh0.dtype == torch.float32
    want_dxg, want_r, want_dh0 = gru_cuda_vjp.gru_bwd_reference(*args)
    assert float((r.float() - want_r.float()).abs().max()) <= GRU_BWD_R_TOL
    assert _rel_err(dxg, want_dxg) <= GRU_BWD_REL_TOL
    assert _rel_err(dh0, want_dh0) <= GRU_BWD_REL_TOL


def test_gru_bwd_kernel_is_deterministic(cuda_device):
    args = _gru_bwd_inputs(cuda_device, 33, 24, 1024, seed=2)
    first = gru_cuda_vjp.gru_bwd(*args)
    second = gru_cuda_vjp.gru_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_bwd_kernel_refuses_what_it_cannot_take(cuda_device):
    with pytest.raises(ValueError):
        gru_cuda_vjp.gru_bwd(*_gru_bwd_inputs(cuda_device, 2, 2, 24))  # H not a multiple of 16
    xg, hp, dhs, w, b = _gru_bwd_inputs(cuda_device, 2, 2, 16)
    with pytest.raises(ValueError):
        gru_cuda_vjp.gru_bwd(xg, hp.float(), dhs, w, b)  # f32 h_prev
    with pytest.raises(RuntimeError):
        # 256 CTAs of 8 units, each holding 200 KB of W_hh: not resident at once
        gru_cuda_vjp.gru_bwd(*_gru_bwd_inputs(cuda_device, 2, 2, 2048))


@pytest.mark.parametrize("T", [0, 1, 20])
@pytest.mark.parametrize("B", [1, 16, 31, 32, 33, 64, 65, 100, 130])
def test_gru_bwd_kernel_at_its_edges(cuda_device, B, T):
    """K6 at H 1024 with no frame (dh0 is zero), one frame and 20; B 1, 16
    (one tile of rows), 31 to 33 and 64, 65 (around the tiles of 16 rows
    multicast in turn), 100 (seven tiles) and 130 (launches of 128 rows and
    2): within its tolerance, the same bits twice, and the workspace's
    counter left zero."""
    args = _gru_bwd_inputs(cuda_device, T, B, 1024, seed=B + T)
    before = gru_cuda_vjp.KERNEL.launches
    out = gru_cuda_vjp.gru_bwd(*args)
    torch.cuda.synchronize()
    assert gru_cuda_vjp.KERNEL.launches == before + 1
    assert [o.shape for o in out] == [(T, B, 3072), (T, B, 1024), (B, 1024)]
    want = gru_cuda_vjp.gru_bwd_reference(*args)
    if T:
        assert float((out[1].float() - want[1].float()).abs().max()) <= GRU_BWD_R_TOL
        assert _rel_err(out[0], want[0]) <= GRU_BWD_REL_TOL
        assert _rel_err(out[2], want[2]) <= GRU_BWD_REL_TOL
    else:
        assert torch.equal(out[2], torch.zeros_like(out[2]))
    again = gru_cuda_vjp.gru_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, out))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    _, counter = gru_cuda_vjp.WORKSPACE.held[(cuda_device.index, stream)][0]
    assert int(counter.abs().sum()) == 0


def test_gru_bwd_kernel_launches_allocations_and_graph_replay(cuda_device):
    """K6 at the training shape (T 128, B 16, H 1024): one kernel a call
    and three allocations, its outputs; a call captured at B 16, replayed
    after an eager B 64 call has outgrown the workspace the graph holds,
    with new inputs in the captured buffers, gives the eager bits; the
    counters are left zero."""
    stream = torch.cuda.Stream(cuda_device)
    small = _gru_bwd_inputs(cuda_device, 128, 16, 1024, seed=5)
    large = _gru_bwd_inputs(cuda_device, 128, 64, 1024, seed=6)
    fn = lambda a=small: gru_cuda_vjp.gru_bwd(*a)
    gru_cuda_vjp.WORKSPACE.held.clear()  # the warm call below makes this stream's set at B 16
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(10):
            fn()
        stream.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 30
    assert _graph_node_types(fn, cuda_device) == [0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn()
    retired = len(gru_cuda_vjp.WORKSPACE.retired)
    with torch.cuda.stream(stream):
        gru_cuda_vjp.gru_bwd(*large)  # a larger workspace; the captured set is kept
    stream.synchronize()
    assert len(gru_cuda_vjp.WORKSPACE.retired) == retired + 1
    small[2].copy_(small[2].flip(0).clone())  # new dhs in the captured buffer
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(c, e) for c, e in zip(captured, fn()))
    for bufs, _, _ in gru_cuda_vjp.WORKSPACE.held.values():
        assert int(bufs[1].abs().sum()) == 0


def test_gru_trainable_runs_k1_forward_and_k6_backward(cuda_device):
    """The layer's gradients on the card (bf16 stream) against its f32
    plain path on the CPU: bf16 streaming of x.W_ih, W_hh and h moves
    every gradient by a few bf16 ulps of its largest value."""
    B, T, E, H = 8, 24, 64, 256
    rng = np.random.default_rng(4)
    k = 1 / np.sqrt(H)
    p = {"w_ih": rng.uniform(-k, k, (E, 3 * H)), "b_ih": rng.uniform(-k, k, (3 * H,)),
         "w_hh": rng.uniform(-k, k, (H, 3 * H)), "b_hh": rng.uniform(-k, k, (3 * H,))}
    x = rng.normal(0, 1, (B, T, E))
    w = rng.normal(0, 1, (B, T, H))

    def grads(device, stream):
        pt = {n: torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
              for n, v in p.items()}
        xt = torch.tensor(x, dtype=torch.float32, device=device, requires_grad=True)
        h0 = torch.zeros(B, H, device=device, requires_grad=True)
        hs, hT = gru_cuda_vjp.gru_trainable(xt, h0, pt, stream_dtype=stream)
        (torch.sum(hs * torch.tensor(w, dtype=torch.float32, device=device))
         + 2.0 * torch.sum(hT ** 2)).backward()
        return [t.grad.cpu() for t in (xt, h0, *pt.values())]

    k1, k6 = gru_cuda.KERNEL.launches, gru_cuda_vjp.KERNEL.launches
    got = grads(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    assert gru_cuda.KERNEL.launches == k1 + 1 and gru_cuda_vjp.KERNEL.launches == k6 + 1
    want = grads("cpu", torch.float32)
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= 2.0 ** -4


# K3 over an int8 cache: as K2, pv = bf16(p * v_scale) is rounded against
# the split's own max in the kernel and the row's in the plain version;
# each pv moves by at most 2^-9 of itself, the output (a convex
# combination of |v| < 5) by 2^-9 * 5, plus its own bf16 rounding
ATTN_Q8_TOL = ATTN_TOL
# K4: bf16 x int8 products are exact in f32 on both sides; the f32 sums of
# K <= 11008 products are taken in another order (the plain version is a
# cuBLAS bf16 GEMM with f32 output), relative to the largest output
W8_REL_TOL = 1e-4


def _attn_q8_inputs(device, B, KV, R, T, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (B, KV, R, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, KV, T, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, KV, T, hd)).astype(np.float32))
    kq, ks = quant.quantize_activations(k.reshape(-1, hd))
    vq, vs = quant.quantize_activations(v.reshape(-1, hd))
    to = lambda a, *shape: a.reshape(*shape).to(device)
    return (q.to(device, torch.bfloat16), to(kq, B, KV, T, hd), to(ks, B, KV, T),
            to(vq, B, KV, T, hd), to(vs, B, KV, T))


@pytest.mark.parametrize("B,KV,R,T,hd", [(2, 2, 1, 128, 128), (3, 4, 2, 192, 64),
                                         (8, 32, 1, 512, 128), (2, 8, 4, 512, 128),
                                         (2, 2, 8, 256, 256), (1, 3, 3, 100, 48)])
def test_decode_attention_q8_kernel_matches_plain(cuda_device, B, KV, R, T, hd):
    args = _attn_q8_inputs(cuda_device, B, KV, R, T, hd)
    valid = torch.tensor(([0, T, 1, 77, 63, 65, 300, 511] * B)[:B], dtype=torch.int32,
                         device=cuda_device).clamp(max=T)  # 0, T, odd and mid-split bounds
    before = da8.KERNEL.launches
    out = da8.decode_attention_q8(*args, valid)
    torch.cuda.synchronize()
    assert da8.KERNEL.launches == before + 1
    want = da8.decode_attention_q8_reference(*args, valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_Q8_TOL)
    assert torch.all(out[valid == 0] == 0)
    for bound in (0, 1, T // 2 + 1):  # a scalar bound reaches the same kernel
        torch.testing.assert_close(da8.decode_attention_q8(*args, bound).float(),
                                   da8.decode_attention_q8_reference(*args, bound).float(),
                                   **ATTN_Q8_TOL)
    assert torch.equal(da8.decode_attention_q8(*args, valid), out)  # the same bits again


# (B, KV, T, R, hd): every R and hd at 4 x 2 kv heads, and R 1, 4, 8 at the
# 7B shape's 8 x 32
K3_BLOCK_CASES = ([(4, 2, 640, R, hd) for R in range(1, 9) for hd in (64, 128, 256)]
                  + [(8, 32, 512, R, hd) for R in (1, 4, 8) for hd in (64, 128, 256)])


@pytest.mark.parametrize("B,KV,T,R,hd", K3_BLOCK_CASES)
def test_decode_attention_q8_kernel_at_block_bounds(cuda_device, B, KV, T, R, hd):
    """K3 with per-row bounds at 0, 1, one past a split's 64 positions, T
    and between, two runs equal in their bits, its scratch reused."""
    P = da8.SPLIT
    args = _attn_q8_inputs(cuda_device, B, KV, R, T, hd, seed=R + hd)
    valid = torch.tensor([0, 1, P + 1, T, P, 2 * P + 1, T - 1, P - 1][:B],
                         dtype=torch.int32, device=cuda_device)
    out = da8.decode_attention_q8(*args, valid)
    torch.cuda.synchronize()
    want = da8.decode_attention_q8_reference(*args, valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_Q8_TOL)
    assert torch.all(out[0] == 0)
    assert torch.equal(da8.decode_attention_q8(*args, valid), out)  # the same bits again


def _w8_inputs(device, M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    q, s = quant.quantize_weight(torch.from_numpy(rng.normal(0, 0.02, (K, N)).astype(np.float32)))
    return x.to(device, torch.bfloat16), q.to(device), s.to(device)


@pytest.mark.parametrize("M", [1, 3, 8, 9, 17, 64, 65, 128, 300, 512, 1000])
@pytest.mark.parametrize("K,N", [(4096, 1000), (4096, 32000), (11008, 4096), (64, 24),
                                 (4104, 1000)])
def test_int8_matmul_kernel_matches_plain(cuda_device, M, K, N):
    """K4: the cluster GEMV up to 8 rows; the wgmma tiles of 64 rows up to
    64, of 128 or 256 above (256 at N 32000 from M 300 and at K 11008 at M
    1000). N 24 and 1000 are no multiple of 16 (8-byte copies of q), K 4104
    no multiple of the stage depth 64."""
    x, q, s = _w8_inputs(cuda_device, M, K, N)
    before = quant.KERNEL_W8.launches
    y = quant.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert quant.KERNEL_W8.launches == before + 1 and y.dtype == torch.float32
    want = quant.int8_matmul_reference(x, q, s)
    assert float((y - want).abs().max()) <= W8_REL_TOL * float(want.abs().max())
    assert torch.equal(quant.int8_matmul(x, q, s), y)  # the same bits again


@functools.lru_cache(maxsize=8)
def _w8_weight(K, N, seed):
    """q (K, N) int8 and s (1, N) on the CPU, made once per shape."""
    rng = np.random.default_rng(seed)
    return quant.quantize_weight(torch.from_numpy(rng.normal(0, 0.02, (K, N)).astype(np.float32)))


def _w8a8_inputs(device, M, K, N, seed=1):
    q, s = _w8_weight(K, N, seed)
    x = np.random.default_rng(seed + M).normal(0, 1, (M, K)).astype(np.float32)
    xq, xs = quant.quantize_activations(torch.from_numpy(x))
    return xq.to(device), xs.to(device), q.to(device), s.to(device)


# the 7B projections (wqkv, wo, w13, w2, lm-head), N 1000 (no multiple of
# 16: q by cp.async on the tile path) and a small odd shape
W8A8_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
               (4096, 1000), (64, 24)]


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 63, 64, 65, 300, 512])
@pytest.mark.parametrize("K,N", W8A8_SHAPES)
def test_int8xint8_matmul_kernel_matches_plain(cuda_device, M, K, N):
    """K5 is exact: int32 sums on both sides, rounded once to f32 and
    scaled in the same order, so kernel and plain agree bit for bit: the
    streaming path up to 8 rows, the wgmma tiles of 64 rows up to 64 and of
    128 or 256 above."""
    xq, xs, q, s = _w8a8_inputs(cuda_device, M, K, N)
    before = quant.KERNEL_W8A8.launches
    y = quant.int8xint8_matmul(xq, xs, q, s)
    torch.cuda.synchronize()
    assert quant.KERNEL_W8A8.launches == before + 1
    assert torch.equal(y, quant.int8xint8_matmul_reference(xq, xs, q, s))
    assert torch.equal(quant.int8xint8_matmul(xq, xs, q, s), y)  # the same bits again


def test_int8xint8_matmul_workspace_is_left_zero(cuda_device):
    """The streaming path's int32 sums and tickets are zero after calls of
    different shapes in a row, so any later call may start from them."""
    for M, (K, N) in ((1, W8A8_SHAPES[0]), (8, W8A8_SHAPES[3]), (3, W8A8_SHAPES[4]),
                      (8, W8A8_SHAPES[0]), (5, W8A8_SHAPES[5])):
        args = _w8a8_inputs(cuda_device, M, K, N)
        assert torch.equal(quant.int8xint8_matmul(*args), quant.int8xint8_matmul_reference(*args))
    torch.cuda.synchronize()
    ws, tickets = quant.W8A8_WORKSPACE.get(
        cuda_device, torch.cuda.current_stream().cuda_stream, 8 * 12288, 1)
    assert ws.numel() >= 8 * 12288 and not torch.any(ws) and not torch.any(tickets)


def test_int8_kernels_refuse_what_they_cannot_take(cuda_device):
    x, q, s = _w8_inputs(cuda_device, 4, 64, 24)
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q[:, :20].contiguous(), s[:, :20].contiguous())  # N 20
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q.float(), s)  # f32 weights
    with pytest.raises(ValueError):
        quant.int8_matmul(x, q.t(), s.t())  # a transposed (non-contiguous) weight
    with pytest.raises(ValueError):
        quant.int8_matmul(x[:, :60].contiguous(), q[:60], s)  # K not a multiple of 8
    xq, xs = quant.quantize_activations(x)
    with pytest.raises(ValueError):
        quant.int8xint8_matmul(x, xs, q, s)  # bf16 activations
    with pytest.raises(ValueError):
        quant.int8xint8_matmul(xq, xs.reshape(-1), q, s)  # scales not (M, 1)
    with pytest.raises(ValueError):
        quant.int8xint8_matmul(xq[:, :56].contiguous(), xs, q[:56], s)  # K not a multiple of 16
    args = _attn_q8_inputs(cuda_device, 1, 2, 1, 64, 64)
    with pytest.raises(ValueError):
        da8.decode_attention_q8(args[0].float(), *args[1:], 3)  # f32 query
    with pytest.raises(ValueError):
        da8.decode_attention_q8(args[0], args[1].to(torch.bfloat16), *args[2:], 3)  # bf16 cache
    with pytest.raises(ValueError):
        da8.decode_attention_q8(args[0], args[1], args[2][..., :32], *args[3:], 3)  # scales cut


# K8: o is the attention output with p rounded against a 64-position
# split's max, as K2 rounds it against its block's, so o differs from the
# plain version's as K2's does (ATTN_TOL); the f32 projection carries that over sum_k o_k wo_k with wo ~
# N(0, 1 / (H hd)), i.e. about one such difference, and the residual
# output rounds h + y to bf16 (|out| < 8: one ulp is 2^-5)
WO_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -5)
# K7: as K7a but f32 out: where an f32 sum of D products lands on a bf16
# boundary of the activation a, a moves one bf16 ulp (2^-8 of |a| < 8),
# and each such move enters y through one w2 element (~F^-0.5)
FFN_ALONE_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -5)


def _wo_inputs(device, B, KV, R, T, hd, D, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, *shape: torch.from_numpy((rng.normal(0, 1, shape) * s).astype(np.float32)).to(
        device, torch.bfloat16)
    return (mk(1.0, B, KV, R, hd), mk(1.0, B, KV, T, hd), mk(1.0, B, KV, T, hd),
            mk((KV * R * hd) ** -0.5, KV * R * hd, D), mk(1.0, B, 1, D))


@pytest.mark.parametrize("B,KV,R,T,hd,D", [(1, 16, 1, 512, 128, 2048), (3, 16, 1, 512, 128, 2048),
                                           (8, 16, 1, 512, 128, 2048), (5, 4, 2, 512, 128, 256),
                                           (4, 2, 4, 192, 64, 512), (12, 16, 1, 512, 128, 2048)])
def test_decode_attention_wo_kernel_matches_plain(cuda_device, B, KV, R, T, hd, D):
    q, k, v, wo, h = _wo_inputs(cuda_device, B, KV, R, T, hd, D)
    valid = torch.tensor(([0, 63, 64, 65, T] * B)[:B], dtype=torch.int32, device=cuda_device)
    before = dwo.KERNEL.launches
    proj = dwo.decode_attention_wo(q, k, v, valid, wo)
    res = dwo.decode_attention_wo(q, k, v, valid, wo, residual=h)
    torch.cuda.synchronize()
    assert dwo.KERNEL.launches == before + 2 * ((B + 7) // 8)
    assert proj.dtype == torch.float32 and res.dtype == torch.bfloat16
    assert proj.shape == res.shape == (B, 1, D)
    torch.testing.assert_close(proj, dwo.decode_attention_wo_reference(q, k, v, valid, wo),
                               **WO_TOL)
    torch.testing.assert_close(res.float(), dwo.decode_attention_wo_reference(
        q, k, v, valid, wo, residual=h).float(), **WO_TOL)
    assert torch.all(proj[valid == 0] == 0) and torch.equal(res[valid == 0], h[valid == 0])
    # the same bits on a second run, and a scalar bound reaches the same kernel
    assert torch.equal(dwo.decode_attention_wo(q, k, v, valid, wo), proj)
    torch.testing.assert_close(dwo.decode_attention_wo(q, k, v, T // 2 + 1, wo),
                               dwo.decode_attention_wo_reference(q, k, v, T // 2 + 1, wo),
                               **WO_TOL)


def _qkv_views(device, B, KV, R, hd, seed=1):
    """k_new / v_new as the model hands them over: (B, KV, 1, hd) views
    into a (B, 1, (H + 2 KV) hd) activation, batch stride (H + 2 KV) hd."""
    H = KV * R
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (B, 1, (H + 2 * KV) * hd)).astype(np.float32)).to(
        device, torch.bfloat16)
    k_new = qkv[..., H * hd : (H + KV) * hd].reshape(B, 1, KV, hd).transpose(1, 2)
    v_new = qkv[..., (H + KV) * hd :].reshape(B, 1, KV, hd).transpose(1, 2)
    return k_new, v_new


@pytest.mark.parametrize("pos", [0, 63, 64, 511])
@pytest.mark.parametrize("B,KV,R,D", [(1, 16, 1, 2048), (8, 16, 1, 2048), (3, 4, 2, 256),
                                      (10, 16, 1, 2048)])
def test_decode_attention_wo_res_upd_kernel_matches_plain(cuda_device, pos, B, KV, R, D):
    T, hd = 512, 128
    q, k, v, wo, h = _wo_inputs(cuda_device, B, KV, R, T, hd, D, seed=pos)
    k_new, v_new = _qkv_views(cuda_device, B, KV, R, hd, seed=pos + 1)
    ck, cv = k.clone(), v.clone()
    before = dwo.KERNEL_UPD.launches
    out, ok, ov = dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, ck, cv, pos, wo)
    torch.cuda.synchronize()
    assert ok is ck and ov is cv and dwo.KERNEL_UPD.launches == before + (B + 7) // 8
    want, rk, rv = dwo.decode_attention_wo_res_upd_reference(
        q, h, k_new, v_new, k.clone(), v.clone(), pos, wo)
    assert torch.equal(ck, rk) and torch.equal(cv, rv)  # write-then-attend, bit for bit
    torch.testing.assert_close(out.float(), want.float(), **WO_TOL)
    # the same as K8 with the residual over the written cache, and the same bits again
    torch.testing.assert_close(out.float(), dwo.decode_attention_wo(
        q, ck, cv, pos + 1, wo, residual=h).float(), **WO_TOL)
    again, _, _ = dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, ck, cv, pos, wo)
    assert torch.equal(again, out)


def test_decode_attention_wo_res_upd_per_row_positions(cuda_device):
    B, KV, R, T, hd, D = 8, 16, 1, 512, 128, 2048
    q, k, v, wo, h = _wo_inputs(cuda_device, B, KV, R, T, hd, D, seed=3)
    k_new, v_new = _qkv_views(cuda_device, B, KV, R, hd, seed=4)
    pos = torch.tensor([0, 62, 63, 64, 65, 127, 128, 511], dtype=torch.int32, device=cuda_device)
    ck, cv = k.clone(), v.clone()
    out, _, _ = dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, ck, cv, pos, wo)
    want, rk, rv = dwo.decode_attention_wo_res_upd_reference(
        q, h, k_new, v_new, k.clone(), v.clone(), pos, wo)
    torch.cuda.synchronize()
    assert torch.equal(ck, rk) and torch.equal(cv, rv)
    torch.testing.assert_close(out.float(), want.float(), **WO_TOL)


@pytest.mark.parametrize("M,D,F", [(1, 2048, 5632), (3, 2048, 5632), (8, 2048, 5632),
                                   (1, 4096, 11008), (5, 4096, 11008), (8, 512, 1000),
                                   (11, 2048, 5632)])
def test_fused_ffn_alone_kernel_matches_plain(cuda_device, M, D, F):
    h, nw, w13, w2 = _ffn_inputs(cuda_device, M, D, F, seed=M)
    x = ffn.rms_norm(h, nw, 1e-5)  # K7 takes the normed rows
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    # F 1000 takes the first design (TMA cannot start a box at column 1000)
    design, step = ffn.ffn_design(D, F, sms)
    launches = -(-M // step)
    kernel = ffn.KERNEL_FFN if design == "ring" else ffn.KERNEL_FFN_FFMA
    before = kernel.launches
    y = ffn.fused_ffn(x, w13, w2)
    torch.cuda.synchronize()
    assert kernel.launches == before + launches
    assert y.dtype == torch.float32 and y.shape == (M, D)
    torch.testing.assert_close(y, ffn.fused_ffn_reference(x, w13, w2), **FFN_ALONE_TOL)
    assert torch.equal(ffn.fused_ffn(x, w13, w2), y)  # the same bits again


@pytest.mark.parametrize("M", [*range(1, 9), 11])
def test_fused_ffn_alone_at_every_decode_row_count(cuda_device, M):
    """K7 at the 1B FFN (D 2048, F 5632) at each row count of one n8 tile,
    and 11 (two tiles): csrc/fused_ffn_bf16.cu's kernel, one launch, the
    same bits twice."""
    h, nw, w13, w2 = _ffn_inputs(cuda_device, M, 2048, 5632, seed=50 + M)
    x = ffn.rms_norm(h, nw, 1e-5)
    before = ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches
    y = ffn.fused_ffn(x, w13, w2)
    torch.cuda.synchronize()
    assert (ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(y, ffn.fused_ffn_reference(x, w13, w2), **FFN_ALONE_TOL)
    assert torch.equal(ffn.fused_ffn(x, w13, w2), y)


def test_fused_ffn_alone_first_design_where_tma_cannot_go(cuda_device):
    """Where TMA cannot take the weights (F 1000: the up columns start at
    column 1000, no 16-byte boundary of a box) K7 runs its first design,
    csrc/fused_ffn.cu's kernels."""
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 3, 512, 1000, seed=3)
    x = ffn.rms_norm(h, nw, 1e-5)
    before = ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches
    y = ffn.fused_ffn(x, w13, w2)
    torch.cuda.synchronize()
    assert (ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(y, ffn.fused_ffn_reference(x, w13, w2), **FFN_ALONE_TOL)


def test_fused_ffn_alone_launches_allocations_and_graph_replay(cuda_device):
    """K7 at the 1B FFN: one kernel a call and one allocation, its output;
    a call captured at M 1, replayed after an eager call at the 7B FFN has
    outgrown the workspace the graph holds (a workspace holds the most rows
    a launch takes, so only a wider FFN outgrows it), with new inputs in
    the captured buffers, gives the eager M 1 bits; the counters are left
    zero. The first design too allocates only its output."""
    stream = torch.cuda.Stream(cuda_device)
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 8, 2048, 5632, seed=1)
    small = [ffn.rms_norm(h[:1], nw, 1e-5).contiguous(), w13, w2]
    h7, nw7, w13_7, w2_7 = _ffn_inputs(cuda_device, 8, 4096, 11008, seed=4)
    large = [ffn.rms_norm(h7, nw7, 1e-5), w13_7, w2_7]
    odd = _ffn_inputs(cuda_device, 3, 512, 1000, seed=2)
    fn = lambda a=small: ffn.fused_ffn(*a)
    fn_odd = lambda: ffn.fused_ffn(odd[0], odd[2], odd[3])
    ffn.WORKSPACE_FFN.held.clear()  # the warm call below makes this stream's set at M 1
    with torch.cuda.stream(stream):
        for f in (fn, fn_odd):
            f()
            stream.synchronize()
            before = torch.cuda.memory_stats()["allocation.all.allocated"]
            for _ in range(10):
                f()
            stream.synchronize()
            assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10
    assert _graph_node_types(fn, cuda_device) == [0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn()
    retired = len(ffn.WORKSPACE_FFN.retired)
    with torch.cuda.stream(stream):
        ffn.fused_ffn(*large)  # a larger workspace; the captured set is kept
    stream.synchronize()
    assert len(ffn.WORKSPACE_FFN.retired) == retired + 1
    small[0].copy_(small[0][..., torch.randperm(2048, device=cuda_device)].clone())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn())
    for bufs, _, _ in ffn.WORKSPACE_FFN.held.values():
        assert int(bufs[3].abs().sum()) == 0


# K7a on the ring against its plain version: chip_smoke.py's bar for
# fused_ffn_block (TOL), the largest |out - plain|: where an f32 sum taken
# in another order straddles a bf16 boundary of a, and then of h + y, the
# output moves an ulp or two (2^-5 at |out| < 8)
K7A_TOL = 2.0 ** -4
# Mistral-7B's FFN, DeepSeek-V2-Lite's dense layer 0, and a small shape (4
# up tiles, 1 down tile)
K7A_SHAPES = [(4096, 14336), (2048, 10944), (256, 1024)]


@pytest.mark.parametrize("D,F", K7A_SHAPES)
def test_k7a_ring_at_every_row_count(cuda_device, D, F):
    """K7a at M 1 to 32 (one launch of csrc/fused_ffn_bf16.cu's ring), 33
    and 40 (two), against the plain version, the same bits on a second
    call; the first design's count does not move."""
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 40, D, F, seed=D + F)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for M in [*range(1, 33), 33, 40]:
        x = h[:M]
        launches = 1 if M <= 32 else 2
        assert ffn.ffn_design(D, F, sms) == ("ring", 32)
        before = ffn.KERNEL_BLOCK.launches, ffn.KERNEL.launches
        out = ffn.fused_ffn_block(x, nw, w13, w2, 1e-5)
        torch.cuda.synchronize()
        assert (ffn.KERNEL_BLOCK.launches, ffn.KERNEL.launches) == (
            before[0] + launches, before[1]), M
        assert out.dtype == torch.bfloat16 and out.shape == (M, D)
        want = ffn.fused_ffn_block_reference(x, nw, w13, w2, 1e-5)
        err = float((out.float() - want.float()).abs().max())
        assert err <= K7A_TOL, (M, err)
        assert torch.equal(ffn.fused_ffn_block(x, nw, w13, w2, 1e-5), out), M


@pytest.mark.parametrize("D,F", K7A_SHAPES[:2])
def test_k7a_row_bits_do_not_depend_on_its_launch(cuda_device, D, F):
    """A row's output is the same bits launched alone, among 32, or in the
    second launch of 40 rows: the ring's sums run in an order that (D, F)
    alone fixes."""
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 40, D, F, seed=7)
    all40 = ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)
    assert torch.equal(ffn.fused_ffn_block(h[:32], nw, w13, w2, 1e-5), all40[:32])
    for r in (0, 5, 8, 17, 31, 32, 39):
        assert torch.equal(ffn.fused_ffn_block(h[r : r + 1], nw, w13, w2, 1e-5),
                           all40[r : r + 1]), r


@pytest.mark.parametrize("M", [24, 25, 26, 32])
def test_ring_call_past_shared_memory_launches_what_fits(cuda_device, M):
    """At 13B's widths (D 5120, F 13824) a split's activations fit shared
    memory for 25 rows: one call of K7a's and of K7's entry point takes M up
    to 32 all the same, in launches of 25 and the rest, with the plain
    version's values and each row's bits as launched alone."""
    D, F = 5120, 13824
    h, nw, w13, w2 = _ffn_inputs(cuda_device, M, D, F, seed=M)
    x = ffn.rms_norm(h, nw, 1e-5)
    before = ffn.KERNEL_BLOCK.launches, ffn.KERNEL_FFN.launches
    out, y = ffn.fused_ffn_block(h, nw, w13, w2, 1e-5), ffn.fused_ffn(x, w13, w2)
    torch.cuda.synchronize()
    assert (ffn.KERNEL_BLOCK.launches, ffn.KERNEL_FFN.launches) == (before[0] + 1, before[1] + 1)
    want = ffn.fused_ffn_block_reference(h, nw, w13, w2, 1e-5)
    assert float((out.float() - want.float()).abs().max()) <= K7A_TOL
    torch.testing.assert_close(y, ffn.fused_ffn_reference(x, w13, w2), **FFN_ALONE_TOL)
    for r in sorted({0, min(25, M - 1), M - 1}):  # row 25 opens the second launch
        assert torch.equal(ffn.fused_ffn_block(h[r : r + 1], nw, w13, w2, 1e-5), out[r : r + 1])
        assert torch.equal(ffn.fused_ffn(x[r : r + 1], w13, w2), y[r : r + 1])


@pytest.mark.parametrize("D,F", [(2048, 2816), (2048, 5632)])
def test_fused_ffn_alone_ring_from_9_to_32_rows(cuda_device, D, F):
    """K7 at DeepSeek-V2-Lite's shared experts (F 2816) and the 1B FFN at M
    9 to 32: one ring launch, the plain version's values, the same bits
    twice."""
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 32, D, F, seed=F)
    x = ffn.rms_norm(h, nw, 1e-5)
    for M in range(9, 33):
        before = ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches
        y = ffn.fused_ffn(x[:M], w13, w2)
        torch.cuda.synchronize()
        assert (ffn.KERNEL_FFN.launches, ffn.KERNEL_FFN_FFMA.launches) == (
            before[0] + 1, before[1]), M
        torch.testing.assert_close(y, ffn.fused_ffn_reference(x[:M], w13, w2), **FFN_ALONE_TOL)
        assert torch.equal(ffn.fused_ffn(x[:M], w13, w2), y), M


def test_k7a_ring_launches_allocations_and_graph_replay(cuda_device):
    """K7a at DeepSeek-V2-Lite's dense layer: one kernel and one allocation,
    its output, a call at any row count; a call captured at M 9, replayed
    after an eager call at Mistral-7B's FFN has outgrown the workspace the
    graph holds, with new inputs in the captured buffers, gives the eager M
    9 bits; the counters are left zero, in the set the graph holds too."""
    stream = torch.cuda.Stream(cuda_device)
    h, nw, w13, w2 = _ffn_inputs(cuda_device, 32, 2048, 10944, seed=3)
    small = h[:9].clone()
    fn = lambda: ffn.fused_ffn_block(small, nw, w13, w2, 1e-5)
    ffn.WORKSPACE_FFN.held.clear()  # the warm call below makes this stream's set
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for M in (9, 1, 32, 17, 9, 9, 2, 8, 31, 9):  # the set made at M 9 takes them all
            ffn.fused_ffn_block(h[:M], nw, w13, w2, 1e-5)
        stream.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10
    assert _graph_node_types(fn, cuda_device) == [0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn()
    retired = len(ffn.WORKSPACE_FFN.retired)
    wide = _ffn_inputs(cuda_device, 32, 4096, 14336, seed=4)
    with torch.cuda.stream(stream):
        ffn.fused_ffn_block(*wide, 1e-5)  # a larger workspace; the captured set is kept
    stream.synchronize()
    assert len(ffn.WORKSPACE_FFN.retired) == retired + 1
    small.copy_(small[..., torch.randperm(2048, device=cuda_device)].clone())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn())
    sets = [bufs for bufs, _, _ in ffn.WORKSPACE_FFN.held.values()] + ffn.WORKSPACE_FFN.retired
    assert all(int(bufs[3].abs().sum()) == 0 for bufs in sets)


# Profiles K7a and K7 at DeepSeek-V2-Lite's dense layer 0 (M 16) and prints
# the device activities' names of each call, one profiler session a call
_PROFILE_K7_NAMES = """
import json, torch
from prego_tpu_torch.ops import fused_ffn as ffn
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev)
gen.manual_seed(5)
rn = lambda *shape, scale=1.0: (torch.randn(*shape, device=dev, generator=gen) * scale).to(
    torch.bfloat16)
D, F = 2048, 10944
h, nw = rn(16, D), rn(D, scale=0.1) + 1
w13, w2 = rn(D, 2 * F, scale=D ** -0.5), rn(F, D, scale=F ** -0.5)
x = ffn.rms_norm(h, nw, 1e-5)
calls = {"K7a": lambda: ffn.fused_ffn_block(h, nw, w13, w2, 1e-5),
         "K7": lambda: ffn.fused_ffn(x, w13, w2)}
for fn in calls.values():  # built and warm
    fn()
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
names = {}
for kernel, fn in calls.items():
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names[kernel] = sorted({e.name for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA})
print(json.dumps(names))
"""


def test_k7a_and_k7_kernel_names_as_the_traces_are_read(cuda_device):
    """Under the profiler K7a's ring kernel carries one of the names
    perf_bench/readers.py reads K7a by, and not perf_bench/moe_counts.py's
    K7 name; K7's kernel the other way round. Profiled in a process of its
    own: on an H100, sessions in this file's process, after its other
    tests, recorded no device activity at all."""
    from perf_bench import moe_counts, readers

    proc = subprocess.run([sys.executable, "-c", _PROFILE_K7_NAMES],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    matches = lambda ns, keys: [n for n in ns if any(k in n for k in keys)]
    assert len(names["K7a"]) == 1 and matches(names["K7a"], readers.K7A), names
    assert not matches(names["K7a"], moe_counts.K7), names
    assert len(names["K7"]) == 1 and matches(names["K7"], moe_counts.K7), names
    assert not matches(names["K7"], readers.K7A), names


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k7a_k7q_digests(device):
    """SHA-256 (16 hex digits) of K7a's and K7q's outputs at the 7B FFN, M
    1 and 8 (and K7a's at M 32), on inputs made with numpy from a seed."""
    out = {}
    for M in (1, 8, 32):
        h, nw, w13, w2 = _ffn_inputs(device, M, 4096, 11008, seed=70 + M)
        out[f"K7a M {M}"] = _digest(ffn.fused_ffn_block(h, nw, w13, w2, 1e-5))
        if M <= 8:
            out[f"K7q M {M}"] = _digest(ffn.fused_ffn_block_q8(
                *_ffn_q8_inputs(device, M, 4096, 11008, seed=80 + M), 1e-5))
    return out


# K7q's digests at 09bfd55, before K7's redesign, and K7a's since it moved
# onto K7's ring (its f32 sums in the ring's split order): neither may move
# (tools/kernel_ab.py holds two checkouts' outputs equal in turns as well)
K7A_K7Q_DIGESTS = {"K7a M 1": "8a8cca75a447f4c3", "K7q M 1": "85ba0cc296fbff7d",
                   "K7a M 8": "83130ccd1fa5083e", "K7q M 8": "19f8d3944fea7d61",
                   "K7a M 32": "dafcadf7e278ef36"}


def test_k7a_and_k7q_outputs_keep_their_bits(cuda_device):
    assert k7a_k7q_digests(cuda_device) == K7A_K7Q_DIGESTS


def test_fused_decode_kernels_refuse_what_they_cannot_take(cuda_device):
    q, k, v, wo, h = _wo_inputs(cuda_device, 2, 2, 1, 64, 128, 256)
    with pytest.raises(ValueError):
        dwo.decode_attention_wo(q.float(), k, v, 3, wo)  # f32 query
    with pytest.raises(ValueError):
        dwo.decode_attention_wo(q, k, v, 3, wo[:128])  # wo rows are not H x hd
    with pytest.raises(ValueError):
        dwo.decode_attention_wo(q, k, v, 3, wo, residual=h.float())  # f32 residual
    q24, k24, v24, wo24, _ = _wo_inputs(cuda_device, 2, 2, 1, 64, 24, 256)
    with pytest.raises(ValueError):
        dwo.decode_attention_wo(q24, k24, v24, 3, wo24)  # hd not a multiple of 16
    k_new, v_new = _qkv_views(cuda_device, 2, 2, 1, 128)
    apart = torch.zeros(2, 1, 2, 256, dtype=torch.bfloat16, device=cuda_device)[..., :128]
    with pytest.raises(ValueError):  # a row's two kv heads 256 values apart, not dense
        dwo.decode_attention_wo_res_upd(q, h, apart.transpose(1, 2), v_new, k, v, 3, wo)
    with pytest.raises(ValueError):
        dwo.decode_attention_wo_res_upd(q, h, k_new.float(), v_new, k, v, 3, wo)  # f32 rows
    x = torch.zeros(2, 60, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        ffn.fused_ffn(x, torch.zeros(60, 352, dtype=torch.bfloat16, device=cuda_device),
                      torch.zeros(176, 60, dtype=torch.bfloat16, device=cuda_device))  # D % 8


# K9: the f32 out (lm-head) differs from the plain version by the order of
# f32 sums, as K4's (W8_REL_TOL), and by the norm: where the kernel's
# 1 / sqrtf and torch.rsqrt round the row's scale an ulp apart, a normed
# value may round to the other bf16 neighbour (2^-8 of one term of K). A
# bf16 out (wqkv) rounds y once more, and the residual out (wo) rounds y and
# then the sum: one bf16 ulp each, 2^-8 of values below max |want|.
DENSE_F32_REL_TOL = W8_REL_TOL
DENSE_BF16_REL_TOL = 2.0 ** -6
# K3m: q8 and the int32 dots are exact on both sides; where expf and
# torch.exp round p an ulp apart, a pv code moves one step (2^-14 of the
# split's largest pv); the output rounds to bf16 (one ulp, 2^-8 relative)
ATTN_MXU_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -7)


def _dense_inputs(device, M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, *shape: torch.from_numpy((rng.normal(0, 1, shape) * s).astype(np.float32))
    q, s = quant.quantize_weight(mk(K ** -0.5, K, N))
    bf = lambda a: a.to(device, torch.bfloat16)
    return bf(mk(1.0, M, K)), q.to(device), s.to(device), bf(mk(0.1, K) + 1), bf(mk(1.0, M, N))


def _dense_case(cuda_device, M, K, N, out):
    x, q, s, nw, res = _dense_inputs(cuda_device, M, K, N, seed=M + N)
    kw = dict(residual=res) if out == "res" else dict(
        norm_weight=nw, out_dtype=torch.bfloat16 if out == "bf16" else torch.float32)
    before = fd.KERNEL.launches
    y = fd.fused_dense_q8(x, q, s, **kw)
    torch.cuda.synchronize()
    assert fd.KERNEL.launches == before + 1  # one call at any M (tiles above 8 rows)
    assert y.dtype == (torch.float32 if out == "f32" else torch.bfloat16) and y.shape == (M, N)
    want = fd.fused_dense_q8_reference(x, q, s, **kw)
    tol = DENSE_F32_REL_TOL if out == "f32" else DENSE_BF16_REL_TOL
    assert float((y.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())
    assert torch.equal(fd.fused_dense_q8(x, q, s, **kw), y)  # the same bits again


@pytest.mark.parametrize("M", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("K,N,out", [(4096, 12288, "bf16"), (4096, 4096, "res"),
                                     (4096, 32000, "f32"), (4096, 1000, "bf16"),
                                     (128, 1000, "res"), (64, 24, "f32")])
def test_fused_dense_q8_kernel_matches_plain(cuda_device, M, K, N, out):
    """K9 at the 7B call shapes (norm + wqkv in bf16, wo + residual, norm +
    lm-head in f32), ragged N and small K, 1 to 16 rows: the streaming path
    up to 8, the tile path above, each with the three epilogues."""
    _dense_case(cuda_device, M, K, N, out)


def test_fused_dense_q8_lm_head_at_64_rows(cuda_device):
    """A 64-row prefill takes K9 at the lm-head (B * S <= 64)."""
    _dense_case(cuda_device, 64, 4096, 32000, "f32")


# K9's decode shapes: the 7B norm + wqkv (bf16 out), wo + residual, norm +
# lm-head (f32 out), and an N that is no multiple of the 128-column tile
K9_DECODE = [(4096, 12288, "bf16"), (4096, 4096, "res"), (4096, 32000, "f32"),
             (4096, 1000, "bf16"), (256, 1000, "res")]
K9_FOLD_AT = (1, 2, 6)  # csrc/fused_dense_q8.cu kNormGemv: the norm in the GEMV at these rows


def _dense_kw(args, out):
    x, q, s, nw, res = args
    return dict(residual=res) if out == "res" else dict(
        norm_weight=nw, out_dtype=torch.bfloat16 if out == "bf16" else torch.float32)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("K,N,out", K9_DECODE)
def test_fused_dense_q8_decode_is_repeatable(cuda_device, M, K, N, out):
    """K9's decode path: the splits are summed in split order, so two calls
    give the same bits, within the plain version's tolerance; and each row
    alone (one row: the norm in the GEMV's prologue) gives the bits of that
    row in the M-row call (a norm launch first at the rows not in
    K9_FOLD_AT)."""
    args = _dense_inputs(cuda_device, M, K, N, seed=3 * M + K)
    kw = _dense_kw(args, out)
    first = fd.fused_dense_q8(*args[:3], **kw)
    second = fd.fused_dense_q8(*args[:3], **kw)
    x, q, s, nw, res = args
    rows = [fd.fused_dense_q8(x[m : m + 1].clone(), q, s, **_dense_kw(
                (None, None, None, nw, res[m : m + 1].clone()), out)) for m in range(M)]
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, torch.cat(rows))
    want = fd.fused_dense_q8_reference(*args[:3], **kw)
    tol = DENSE_F32_REL_TOL if out == "f32" else DENSE_BF16_REL_TOL
    assert float((first.float() - want.float()).abs().max()) <= tol * float(
        want.float().abs().max())


@pytest.mark.parametrize("B,KV,R,hd,D", [(1, 16, 1, 128, 2048), (2, 4, 8, 64, 512),
                                         (5, 2, 4, 256, 256), (8, 16, 1, 128, 2048),
                                         (7, 8, 2, 128, 1000)])
def test_decode_attention_wo_kernels_are_repeatable(cuda_device, B, KV, R, hd, D):
    """K8 (both bodies) and K8u: bounds 0, 1, a split boundary and T among
    the rows; the head partials meet in the workspace in head order, so two
    calls give the same bits, and K8u's caches equal write-then-attend."""
    T = 512
    q, k, v, wo, h = _wo_inputs(cuda_device, B, KV, R, T, hd, D, seed=B + R)
    valid = torch.tensor([0, 1, 64, T, 65, 63, 300, 511][:B], dtype=torch.int32,
                         device=cuda_device)
    for residual in (None, h):
        first = dwo.decode_attention_wo(q, k, v, valid, wo, residual=residual)
        assert torch.equal(dwo.decode_attention_wo(q, k, v, valid, wo, residual=residual), first)
        torch.testing.assert_close(first.float(), dwo.decode_attention_wo_reference(
            q, k, v, valid, wo, residual).float(), **WO_TOL)
    k_new, v_new = _qkv_views(cuda_device, B, KV, R, hd, seed=B)
    pos = (valid - 1).clamp(min=0)
    ck, cv = k.clone(), v.clone()
    out, _, _ = dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, ck, cv, pos, wo)
    again, _, _ = dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, ck, cv, pos, wo)
    want, rk, rv = dwo.decode_attention_wo_res_upd_reference(
        q, h, k_new, v_new, k.clone(), v.clone(), pos, wo)
    torch.cuda.synchronize()
    assert torch.equal(again, out) and torch.equal(ck, rk) and torch.equal(cv, rv)
    torch.testing.assert_close(out.float(), want.float(), **WO_TOL)


def test_decode_attention_wo_counters_are_left_zero(cuda_device):
    """The projection's column-tile counters are zero after K8 and K8u
    calls of different shapes in a row, so any later call (or a graph's
    replay) may start from them."""
    for B, KV, R, hd, D in ((1, 16, 1, 128, 2048), (8, 4, 2, 64, 1000), (3, 2, 8, 256, 4096),
                            (8, 16, 1, 128, 2048)):
        q, k, v, wo, h = _wo_inputs(cuda_device, B, KV, R, 512, hd, D, seed=B)
        dwo.decode_attention_wo(q, k, v, 300, wo, residual=h)
        k_new, v_new = _qkv_views(cuda_device, B, KV, R, hd, seed=B)
        dwo.decode_attention_wo_res_upd(q, h, k_new, v_new, k, v, 299, wo)
    torch.cuda.synchronize()
    *_, tickets = dwo.WORKSPACE.get(cuda_device, torch.cuda.current_stream().cuda_stream,
                                    0, 0, 0, 64)
    assert tickets.numel() >= 64 and not torch.any(tickets)


def _k8_k9_calls(device):
    """One call each of K8 (with and without the residual) and K8u at the
    1B shape, B 1 and 8, and of K9's three 7B decode sites at M 1 and 8:
    (name, call, kernels a call launches, the tensors it reads)."""
    calls = []
    for B in (1, 8):
        q, k, v, wo, h = _wo_inputs(device, B, 16, 1, 512, 128, 2048, seed=B)
        valid = torch.tensor([300, 0, 512, 1, 77, 255, 256, 511][:B], dtype=torch.int32,
                             device=device)
        k_new, v_new = _qkv_views(device, B, 16, 1, 128, seed=B)
        pos = (valid - 1).clamp(min=0)
        calls += [
            (f"K8 B {B}", lambda a=(q, k, v, valid, wo): dwo.decode_attention_wo(*a), 2,
             (q, k, v, wo)),
            (f"K8 res B {B}", lambda a=(q, k, v, valid, wo, h): dwo.decode_attention_wo(*a), 2,
             (q, k, v, wo, h)),
            (f"K8u B {B}", lambda a=(q, h, k_new, v_new, k, v, pos, wo):
                dwo.decode_attention_wo_res_upd(*a)[0], 2, (q, h, k_new, v_new, wo)),
        ]
    for M in (1, 8):
        for K, N, out in K9_DECODE[:3]:
            args = _dense_inputs(device, M, K, N, seed=M)
            kernels = 2 if out == "res" or M in K9_FOLD_AT else 3
            calls.append((f"K9 {out} M {M}", lambda a=args, kw=_dense_kw(args, out):
                          fd.fused_dense_q8(*a[:3], **kw), kernels, args))
    return calls


def test_k8_and_k9_launch_counts_and_allocate_only_their_output(cuda_device):
    """K8 and K8u: two kernels a call (pass 1 and the projection launched as
    its programmatic dependent, no reduce kernel); K9 at M <= 8: the GEMV
    and a plainly launched reduce, in norm mode with the norm in the GEMV's
    prologue at the rows of K9_FOLD_AT, else after a norm launch (the GEMV
    its programmatic dependent at some row counts). Each allocates its
    output alone once its workspace is as large as it needs; the kernels are
    counted as the nodes of a captured call."""
    calls = _k8_k9_calls(cuda_device)
    for _, fn, _, _ in calls:  # built, warm, and their workspaces made
        fn()
    torch.cuda.synchronize()
    for name, fn, kernels, _ in calls:
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(10):
            fn()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10, name
        assert _graph_node_types(fn, cuda_device) == [0] * kernels, name


def test_k8_and_k9_replay_from_a_cuda_graph(cuda_device):
    """A call captured in a CUDA graph (K8's and K9's programmatic edges and
    K8's tickets included), replayed with new inputs copied into the same
    buffers, gives the eager call's bits on those inputs."""
    stream = torch.cuda.Stream(cuda_device)
    for name, fn, _, inputs in _k8_k9_calls(cuda_device):
        with torch.cuda.stream(stream):
            fn()  # the workspace for this stream
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = fn()
        fresh = [t.clone() for t in inputs]
        for t in fresh:  # new values of the same kinds: permuted along the last dim
            t.copy_(t[..., torch.randperm(t.shape[-1], device=cuda_device)])
        for t, f in zip(inputs, fresh):
            t.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, fn()), name


def test_k8_and_k9_graph_replays_after_the_workspace_grows(cuda_device):
    """A call captured at B 1 (K8, K8u) or M 1 (K9), then an eager call at B
    8 or M 8 on the same stream, which outgrows the workspace the graph
    holds; the replay, with new inputs in the captured buffers, still gives
    the eager B 1 or M 1 bits, and leaves the tensors allocated after the
    growth (which may take memory a freed workspace held) untouched."""
    stream = torch.cuda.Stream(cuda_device)
    small, large = [], []
    for name, fn, _, inputs in _k8_k9_calls(cuda_device):
        (small if name.endswith(" 1") else large).append((name, fn, inputs))
    for (name, fn, inputs), (_, grow, _) in zip(small, large):
        ws = dwo.WORKSPACE if name.startswith("K8") else fd.WORKSPACE
        ws.held.clear()  # the warm call below makes this stream's set, at the small shape
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            captured = fn()
        retired = len(ws.retired)
        with torch.cuda.stream(stream):
            grow()  # a larger workspace for this stream; the captured set is kept
        stream.synchronize()
        assert len(ws.retired) == retired + 1, name
        sentinels = [torch.full((n,), 7, dtype=torch.int32, device=cuda_device)
                     for n in (1 << 10, 1 << 14, 1 << 18, 1 << 20)]
        for t in inputs:  # new values of the same kinds: permuted along the last dim
            t.copy_(t[..., torch.randperm(t.shape[-1], device=cuda_device)].clone())
        graph.replay()
        torch.cuda.synchronize()
        assert all(bool(torch.all(t == 7)) for t in sentinels), name
        assert torch.equal(captured, fn()), name


def _ffn_q8_inputs(device, M, D, F, seed=0):
    h, nw, w13, w2 = _ffn_inputs("cpu", M, D, F, seed)
    w13q, w13s = quant.quantize_weight(w13.float())
    w2q, w2s = quant.quantize_weight(w2.float())
    return [a.to(device) for a in (h, nw, w13q, w13s, w2q, w2s)]


@pytest.mark.parametrize("M,D,F", [(1, 64, 176), (3, 256, 512), (8, 512, 1000),
                                   (1, 4096, 11008), (8, 4096, 11008),
                                   (12, 512, 1000), (16, 4096, 11008)])  # in calls of 8 rows
def test_fused_ffn_block_q8_kernel_matches_plain(cuda_device, M, D, F):
    args = _ffn_q8_inputs(cuda_device, M, D, F, seed=M)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    # F 1000 takes the first design (TMA cannot start a box at column 1000)
    kernel = ffn.KERNEL_Q8 if ffn.ring_splits(D, F, sms) else ffn.KERNEL_Q8_FFMA
    before = kernel.launches
    out = ffn.fused_ffn_block_q8(*args, 1e-5)
    torch.cuda.synchronize()
    assert kernel.launches == before + (M + 7) // 8
    assert out.dtype == torch.bfloat16 and out.shape == (M, D)
    want = ffn.fused_ffn_block_q8_reference(*args, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), **FFN_TOL)
    assert torch.equal(ffn.fused_ffn_block_q8(*args, 1e-5), out)  # the same bits again


@pytest.mark.parametrize("M", range(1, 9))
def test_fused_ffn_block_q8_at_every_decode_row_count(cuda_device, M):
    """K7q at the 7B FFN (D 4096, F 11008) at each row count a call takes:
    csrc/fused_ffn_q8.cu's kernel, the same bits twice."""
    args = _ffn_q8_inputs(cuda_device, M, 4096, 11008, seed=40 + M)
    before = ffn.KERNEL_Q8.launches, ffn.KERNEL_Q8_FFMA.launches
    out = ffn.fused_ffn_block_q8(*args, 1e-5)
    torch.cuda.synchronize()
    assert (ffn.KERNEL_Q8.launches, ffn.KERNEL_Q8_FFMA.launches) == (before[0] + 1, before[1])
    want = ffn.fused_ffn_block_q8_reference(*args, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), **FFN_TOL)
    assert torch.equal(ffn.fused_ffn_block_q8(*args, 1e-5), out)


def test_fused_ffn_block_q8_first_design_where_tma_cannot_go(cuda_device):
    """Where TMA cannot take the weights (F 172: w13's rows of 344 bytes,
    no multiple of 16) K7q runs its first design, K7a's kernels over int8."""
    args = _ffn_q8_inputs(cuda_device, 3, 64, 172, seed=3)
    before = ffn.KERNEL_Q8.launches, ffn.KERNEL_Q8_FFMA.launches
    out = ffn.fused_ffn_block_q8(*args, 1e-5)
    torch.cuda.synchronize()
    assert (ffn.KERNEL_Q8.launches, ffn.KERNEL_Q8_FFMA.launches) == (before[0], before[1] + 1)
    want = ffn.fused_ffn_block_q8_reference(*args, 1e-5)
    torch.testing.assert_close(out.float(), want.float(), **FFN_TOL)


def test_fused_ffn_block_q8_launches_allocations_and_graph_replay(cuda_device):
    """K7q at the 7B FFN: one kernel a call and one allocation, its output;
    a call captured at M 1, replayed after an eager M 8 call has outgrown
    the workspace the graph holds, with new inputs in the captured buffers,
    gives the eager M 1 bits; the counters are left zero."""
    stream = torch.cuda.Stream(cuda_device)
    small = _ffn_q8_inputs(cuda_device, 1, 4096, 11008, seed=1)
    large = [small[0].new_empty(8, 4096).copy_(torch.randn(8, 4096)), *small[1:]]
    fn = lambda a=small: ffn.fused_ffn_block_q8(*a, 1e-5)
    ffn.WORKSPACE_Q8.held.clear()  # the warm call below makes this stream's set at M 1
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(10):
            fn()
        stream.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 10
    assert _graph_node_types(fn, cuda_device) == [0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        captured = fn()
    retired = len(ffn.WORKSPACE_Q8.retired)
    with torch.cuda.stream(stream):
        ffn.fused_ffn_block_q8(*large, 1e-5)  # a larger workspace; the captured set is kept
    stream.synchronize()
    assert len(ffn.WORKSPACE_Q8.retired) == retired + 1
    small[0].copy_(small[0][..., torch.randperm(4096, device=cuda_device)].clone())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, fn())
    for bufs, _, _ in ffn.WORKSPACE_Q8.held.values():
        assert int(bufs[3].abs().sum()) == 0


@pytest.mark.parametrize("B,KV,R,T,hd", [(2, 2, 1, 128, 128), (3, 4, 2, 192, 64),
                                         (8, 32, 1, 512, 128), (8, 8, 4, 512, 128),
                                         (2, 2, 8, 256, 256), (1, 3, 3, 100, 48)])
def test_decode_attention_q8_mxu_kernel_matches_plain(cuda_device, B, KV, R, T, hd):
    """K3m at K3's shapes, ragged bounds among them 0 and T."""
    args = _attn_q8_inputs(cuda_device, B, KV, R, T, hd, seed=R)
    valid = torch.tensor(([0, T, 1, 77, 63, 65, 300, 511] * B)[:B], dtype=torch.int32,
                         device=cuda_device).clamp(max=T)
    before = da8.KERNEL_MXU.launches, da8.KERNEL.launches
    out = da8.decode_attention_q8(*args, valid, int8_mxu=True)
    torch.cuda.synchronize()
    assert (da8.KERNEL_MXU.launches, da8.KERNEL.launches) == (before[0] + 1, before[1])
    want = da8.decode_attention_q8_mxu_reference(*args, valid)
    torch.testing.assert_close(out.float(), want.float(), **ATTN_MXU_TOL)
    assert torch.all(out[valid == 0] == 0)
    for bound in (1, T // 2 + 1):  # a scalar bound reaches the same kernel
        torch.testing.assert_close(
            da8.decode_attention_q8(*args, bound, int8_mxu=True).float(),
            da8.decode_attention_q8_mxu_reference(*args, bound).float(), **ATTN_MXU_TOL)
    assert torch.equal(da8.decode_attention_q8(*args, valid, int8_mxu=True), out)


def test_int8_fusion_kernels_refuse_what_they_cannot_take(cuda_device):
    x, q, s, nw, res = _dense_inputs(cuda_device, 2, 64, 24)
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x, q, s, norm_weight=nw, residual=res)  # both modes
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x, q, s)  # neither
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x.float(), q, s, norm_weight=nw)  # f32 x
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x, q, s, residual=res.float())  # f32 residual
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x, q, s, norm_weight=nw, out_dtype=torch.float16)  # f16 out
    with pytest.raises(ValueError):
        fd.fused_dense_q8(x, q[:, :20].contiguous(), s[:, :20].contiguous(), norm_weight=nw)
    h, nw, w13q, w13s, w2q, w2s = _ffn_q8_inputs(cuda_device, 2, 64, 176)
    with pytest.raises(ValueError):
        ffn.fused_ffn_block_q8(h, nw, w13q.float(), w13s, w2q, w2s, 1e-5)  # f32 weights
    with pytest.raises(ValueError):
        ffn.fused_ffn_block_q8(h, nw, w13q, w13s[:, :176].contiguous(), w2q, w2s, 1e-5)
    with pytest.raises(ValueError):
        ffn.fused_ffn_block_q8(h.float(), nw, w13q, w13s, w2q, w2s, 1e-5)  # f32 stream
    args = _attn_q8_inputs(cuda_device, 1, 2, 9, 64, 64)
    with pytest.raises(ValueError):
        da8.decode_attention_q8(*args, 3, int8_mxu=True)  # R above 8
    args = _attn_q8_inputs(cuda_device, 1, 2, 1, 64, 24)
    with pytest.raises(ValueError):
        da8.decode_attention_q8(*args, 3, int8_mxu=True)  # hd not a multiple of 16


# ---- the recognition trainer's other settings: the native data engine's
# pinned handover, and K1 + K6 under MiniROADA ----


def _native_split(root, n_videos=6, dim=2048, classes=7, seed=0):
    """Videos in the feature store's layout (rgb, zeroed flow, targets)."""
    rng = np.random.default_rng(seed)
    for sub in ("rgb_anet_resnet50", "target_perframe"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    vids = []
    for i in range(n_videos):
        T = int(rng.integers(80, 200))
        np.save(root / "rgb_anet_resnet50" / f"v{i}.npy",
                rng.normal(0, 1, (T, dim)).astype(np.float32))
        np.save(root / "target_perframe" / f"v{i}.npy",
                np.eye(classes, dtype=np.float32)[rng.integers(0, classes, T)])
        vids.append(f"v{i}")
    return vids


def test_pinned_ring_batches_equal_numpy_under_a_slowed_step(cuda_device, tmp_path):
    """Every copy waits behind a 2 ms sleep on the stream and the host never
    waits for the card, so it runs many batches ahead: the ring must wait on
    each slot's event before the pool writes the slot again, or a queued
    copy reads the next batch. The batches on the card equal the numpy
    sampler's bit for bit."""
    from prego_tpu_torch.data import (
        NativeRecognitionData, NativeWindowSampler, WindowSampler, load_feature_store,
    )

    vids = _native_split(tmp_path)
    kw = dict(rgb_type="rgb_anet_resnet50", flow_type="flow_anet_resnet50",
              annotation_type="target_perframe", num_classes=7, training=True, window_size=32)
    native = NativeRecognitionData(str(tmp_path), vids, **kw)
    store = load_feature_store(str(tmp_path), vids, **kw)
    sampler = NativeWindowSampler(native, 32, 4, device=cuda_device)
    ref = WindowSampler(store, 32, 4)
    for s in (sampler, ref):
        s.resample(np.random.default_rng(1))
    on_card, ptrs = [], set()
    cycles = int(2e-3 * torch.cuda.get_device_properties(cuda_device).clock_rate * 1e3)
    for epoch in range(2):
        for batch in sampler.iter_batches(8, rng=np.random.default_rng(2 + epoch)):
            assert batch.rgb.is_pinned() and batch.target.is_pinned()
            ptrs.add(batch.rgb.data_ptr())
            torch.cuda._sleep(cycles)  # the step before the copy, slowed
            on_card.append((batch.rgb.to(cuda_device, non_blocking=True),
                            batch.target.to(cuda_device, non_blocking=True)))
            batch.on_copied()
    torch.cuda.synchronize()
    want = [b for e in range(2) for b in ref.iter_batches(8, rng=np.random.default_rng(2 + e))]
    assert len(want) == len(on_card) > 40
    for (rgb, tgt), w in zip(on_card, want):
        np.testing.assert_array_equal(rgb.cpu().numpy(), w.rgb)
        np.testing.assert_array_equal(tgt.cpu().numpy(), w.target)
    assert len(ptrs) == 3 and sampler.ring.replaced == 0  # three pinned slots, reused


def test_k1_and_k6_under_miniroada(cuda_device):
    """MiniROADA's train step (K1 forward, K6 backward) and its eval forward
    (K1 at B 1) on the card against the same bf16 dtype walk on the CPU
    (the kernels' plain versions): loss within 1e-4 of itself, gradients
    within 2e-2 in norm, as the OAD train step in chip_smoke.py."""
    from prego_tpu_torch.checkpoint.io import tree_leaves
    from prego_tpu_torch.core import RecognitionConfig, make_generator
    from prego_tpu_torch.models import MiniROADA
    from prego_tpu_torch.train import build_optimizer, make_ant_train_step

    cfg = RecognitionConfig.from_dict({
        "model": "MiniROADA", "rgb_type": "rgb_anet_resnet50", "embedding_dim": 128,
        "hidden_dim": 64, "num_classes": 9, "anticipation_length": 4, "dropout": 0.0,
        "optimizer": "AdamW"})
    model = MiniROADA(cfg)
    init = model.init(make_generator(0))
    rng = np.random.default_rng(5)
    rgb = torch.from_numpy(rng.normal(0, 1, (8, 32, 2048)).astype(np.float32))
    ant = torch.from_numpy(np.eye(9, dtype=np.float32)[rng.integers(0, 9, (8, 4))])
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        params = {k: ([{kk: vv.to(device, copy=True) for kk, vv in g.items()} for g in v]
                      if isinstance(v, list) else {kk: vv.to(device, copy=True)
                                                   for kk, vv in v.items()})
                  for k, v in init.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        step = make_ant_train_step(model, build_optimizer(cfg, params), flow_is_zero=True,
                                   gru_backend="pallas_train")
        k1, k6 = gru_cuda.KERNEL.launches, gru_cuda_vjp.KERNEL.launches
        loss = float(step(params, rgb.to(device), None, ant.to(device), torch.ones(8, device=device),
                          None))
        launched = (gru_cuda.KERNEL.launches - k1, gru_cuda_vjp.KERNEL.launches - k6)
        with torch.no_grad():
            scores = model.forward_full(params, rgb[:1].to(device), None, flow_is_zero=True,
                                        backend="kernel")
        out[device.type] = (loss, [p.grad.cpu() for p in leaves], launched,
                            [s.cpu() for s in scores])
    loss, grads, launched, scores = out["cuda"]
    ref_loss, ref_grads, ref_launched, ref_scores = out["cpu"]
    assert launched == (1, 1) and ref_launched == (0, 0)
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    for g, r in zip(grads, ref_grads):
        assert float((g - r).norm()) <= 2e-2 * float(r.norm())
    for s, r in zip(scores, ref_scores):  # softmax scores after K1 at B 1 over 32 frames
        assert float((s - r).abs().max()) <= 2.0 ** -6
