"""Roofline, mfu and idle arithmetic on shapes worked out by hand."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from conftest import BENCH_DIR
from perf_bench import readers, tracing, yardstick

MISTRAL = json.loads((BENCH_DIR / "configs" / "mistral-7b.json").read_text())["llm"]


def test_span_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (4.0, 4.5)]
    assert yardstick.span_union(spans) == [[0.0, 2.0], [3.0, 4.5]]
    assert yardstick.union_length(spans) == pytest.approx(3.5)
    assert yardstick.idle_gaps(spans, 0.0, 6.0) == [(2.0, 3.0), (4.5, 6.0)]
    assert yardstick.idle_gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_k7a_bound_at_mistral_width():
    # w13 and w2: 3 x 4096 x 14336 bf16 = 352,321,536 bytes, plus the norm
    # (4096) and 8 rows in and out (2 x 8 x 4096), 2 bytes each
    flops, nbytes = yardstick.k7a_launch(MISTRAL, 8)
    assert nbytes == 2 * (3 * 4096 * 14336 + 4096 + 2 * 8 * 4096)
    assert flops == 2 * 8 * 3 * 4096 * 14336
    assert yardstick.bound_s(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_k2_bound_reads_the_live_cache_once():
    # 4 rows x 8 kv heads x 500 positions x 128, K and V, bf16; q and out 4 x 32 x 128
    flops, nbytes = yardstick.k2_launch(MISTRAL, 4, 500)
    assert nbytes == 2 * (2 * 4 * 8 * 500 * 128 + 2 * 4 * 32 * 128)
    assert flops == 4 * 4 * 32 * 500 * 128


def test_gru_bounds_match_the_kernel_table():
    # PERF.md's table: K1 at B 16 T 128 is bound by operations, 2 B T H 3H
    f, b = yardstick.gru_fwd_launch(16, 128, 1024)
    assert f == 2 * 16 * 128 * 1024 * 3072
    assert yardstick.bound_s(f, b) == pytest.approx(f / 989e12)
    f6, _ = yardstick.gru_bwd_launch(16, 128, 1024)
    assert yardstick.bound_s(f6, 0) * 1e3 == pytest.approx(0.0261, abs=5e-5)  # PERF.md's K6


def test_llama_call_flops_by_hand():
    c = {"dim": 4, "n_layers": 1, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
         "ffn_hidden": 8, "vocab_size": 10}
    per_token = 2 * yardstick.llama_matmul_params(c)
    assert yardstick.llama_matmul_params(c) == 4 * 4 * 2 + 4 * 4 + 3 * 4 * 8
    # prompts [1,2,3] and [1,2,4,5] share [1,2]; 2 and 1 served tokens
    flops = yardstick.llama_call_flops(c, [[1, 2, 3], [1, 2, 4, 5]], [2, 1])
    positions = [0, 1] + [2, 3] + [2, 3]  # prefix once; suffix + served-but-last
    keys = sum(p + 1 for p in positions)
    attn = 4 * 1 * 2 * 2
    assert flops == per_token * len(positions) + attn * keys + 2 * 3 * 4 * 10


def test_miniroad_step_flops_by_hand():
    f = yardstick.miniroad_step_flops(2, 3, 5, 4, 2, 7)
    BT = 6
    assert f == 2 * (2 * BT * 5 * 4) + 3 * (2 * BT * 4 * 6 + 2 * BT * 2 * 6 + 2 * 2 * 2 * 7)


def _loop(device, window_s, spans=(), calls=()):
    tr = tracing.Trace(window_s=window_s, device=list(device), spans=list(spans))
    return SimpleNamespace(trace=tr, traced_calls=list(calls))


def test_device_idle_and_mfu():
    loop = _loop([("k", 0.0, 1.0), ("k", 0.5, 1.5), ("m", 3.0, 4.0)], 4.0)
    assert readers.device_idle(loop) == pytest.approx(100 * (1 - 2.5 / 4.0))
    assert readers.mfu(loop, 989e12 * 2.0) == pytest.approx(50.0)
    assert readers.device_idle(_loop([], 1.0)) is None
    assert readers.mfu(_loop([], 1.0), 1e12) is None


def test_roofline_over_the_union_of_a_kernels_spans():
    assert readers.roofline([1.0, 1.0], [(0.0, 2.0), (1.0, 4.0)]) == pytest.approx(50.0)
    assert readers.roofline([1.0], []) is None


def test_kernels_are_assigned_to_their_call():
    calls = ["a", "b"]
    loop = _loop([("decode_cluster_kernel", 0.1, 0.2), ("decode_cluster_kernel", 1.1, 1.2),
                ("ffn_up_kernel<8>", 1.3, 1.4)], 2.0,
               spans=[("call", 0.0, 1.0), ("call", 1.0, 2.0)], calls=calls)
    got = readers.per_call_kernels(loop, readers.K2)
    assert [(c, len(ks)) for c, ks in got] == [("a", 1), ("b", 1)]
    assert len(readers.per_call_kernels(loop, readers.K7A)[1][1]) == 1


def test_breakdown_names_the_host_operation_over_a_gap():
    tr = tracing.Trace(window_s=3.0, device=[("k1", 0.0, 1.0), ("k2", 2.0, 3.0)],
                       host=[("outer", 0.0, 3.0, 1), ("aten::mm", 1.2, 1.8, 1)])
    b = tr.breakdown()
    assert b["device_ops"] == [["k1", 1.0], ["k2", 1.0]]
    assert b["idle_gaps"] == [["aten::mm", 1.0]]
    assert math.isclose(tr.busy_s, 2.0)
