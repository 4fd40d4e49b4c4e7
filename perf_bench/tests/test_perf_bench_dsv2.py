"""The cell ``anticipate-dsv2lite`` at a size the CPU runs: DeepSeek-V2's
loop, tree, reference and readers. The tiny root gives the loop the tiny
LLaMA block's shared keys (dim 64, 4 heads) beside the configuration's own
``deepseek_v2`` block, and here the tiny traffic of ``offline-collection``
with the real cell's 320 checked tokens. The model here has 4 layers (one
dense, three MoE), not the tiny root's 2: with one MoE layer a decode
state left unchanged moved one seed's mean gap only to 0.0015-0.0047
(seed 5, on the CPU), under the limit, while at 4 layers it reads
0.0096-0.135 over seeds 5-7."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

import conftest
from conftest import ROOT
from perf_bench import moe_counts, run, spec, tracing, yardstick
from perf_bench import program_spans as ps

CELL = "anticipate-dsv2lite"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = conftest.write_tiny_root(tmp_path_factory.mktemp("dsv2_root"))
    path = root / "perf_bench" / "traffic" / "offline-collection-dsv2.json"
    t = json.loads(path.read_text())
    t.update(conftest.TINY_TRAFFIC["offline-collection"], check_tokens=320)
    path.write_text(json.dumps(t))
    path = root / "perf_bench" / "configs" / "deepseek-v2-lite.json"
    cfg = json.loads(path.read_text())
    cfg["llm"]["n_layers"] = 4
    path.write_text(json.dumps(cfg))
    return spec.Bench(root)


def _run(bench, seed=5, seconds=4.0, trace=False):
    return run.run_cell(bench, CELL, seed, seconds, trace, torch.device("cpu"))


def test_a_tiny_run_is_correct(bench):
    out = _run(bench)
    assert out["correct"], out["checks"]
    assert out["checks"]["mean_gap"]["value"] == 0.0  # float32 on both sides
    assert set(out["metrics"]) == {"checks_per_s", "setup_s"}


def test_the_loops_tree_is_the_ports_and_the_reference_reads_it(bench):
    """The tree drawn from the seed, served by the port's forward in float32,
    gives the reference's logits: the two read one layout."""
    from perf_bench.loops.anticipate_dsv2 import dsv2_config, dsv2_tree
    from perf_bench.reference import deepseek_v2 as ref
    from prego_tpu_torch.models.llama.model import forward, init_cache, precompute_rope

    cell = bench.cell(CELL)
    c = {**cell.config["llm"], **cell.config["deepseek_v2"]}
    cfg = dsv2_config(c, cell.traffic)
    tree = dsv2_tree(cfg, 2 ** 31 + 17, torch.device("cpu"), torch.float32)
    seq = [256] + list(range(40, 90))
    logits, _ = forward(tree, torch.tensor([seq]), 0, init_cache(cfg, 1, torch.float32), cfg,
                        precompute_rope(cfg))
    (want,) = ref.logits_at(tree, c, [seq], [list(range(len(seq)))])
    torch.testing.assert_close(logits[0], want, rtol=1e-4, atol=1e-4)  # f32 both: sum order only
    again = dsv2_tree(cfg, 2 ** 31 + 17, torch.device("cpu"), torch.float32)
    assert torch.equal(again["layers"][1]["moe"]["w13"], tree["layers"][1]["moe"]["w13"])


@pytest.mark.parametrize("fault", ["_altered_token", "_half_batch_served",
                                   "_decode_state_unchanged"])
def test_faults_are_not_correct(bench, monkeypatch, fault):
    import test_perf_bench_faults as faults

    getattr(faults, fault)(monkeypatch)
    out = _run(bench)
    assert not out["correct"], out["checks"]


def test_the_reference_alone_loads_nothing_of_the_port():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import perf_bench.reference.deepseek_v2, perf_bench.moe_counts
print(sorted(m for m in sys.modules if m.split(".")[0] in ("prego_tpu_torch", "prego_tpu", "jax")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_every_new_reader_reads_a_number_on_a_tiny_traced_run(bench):
    """A tiny traced window on the CPU, with device spans laid under each
    traced call as the card's trace would hold them (the CPU has none):
    half the call busy, a tenth of it in a kernel named as the grouped
    GEMMs are, a twentieth in K7 and a fortieth in K7a. Each roofline reads
    its bound over its kernels' time: the counters' for the routed
    experts, one FFN a decode step and layer for K7 and K7a."""
    cell = bench.cell(CELL)
    loop = spec.loop(cell.traffic["loop"]).Loop(cell, 7, torch.device("cpu"))
    loop.setup()
    try:
        tracer = tracing.Tracer(torch.device("cpu"))
        loop.window(1.0, tracer)
        loop.trace = tracer.result()
        calls = loop.trace.in_span("call")
        assert calls and len(calls) == len(loop.traced_calls)
        assert loop.trace.device == []
        shares = {"other": 0.5, "cutlass_GroupProblemShape_kernel": 0.1,
                  "void (anonymous namespace)::ffn_kernel<8>(CUtensorMap_st)": 0.05,
                  "void ffn_reduce_kernel<true, __nv_bfloat16>(float const*)": 0.025}
        for s, e in calls:
            for name, share in shares.items():
                loop.trace.device.append((name, s, s + share * (e - s)))
        names = [m["name"] for m in cell.per_layer]
        assert sorted(names) == sorted([
            "mfu.dsv2", "device_idle.dsv2", "moe_roofline.dsv2", "moe_device_ms.dsv2",
            "decode_step_ms.dsv2", "decode_idle.dsv2", "K7_roofline.dsv2", "K7a_roofline.dsv2"])
        values = {n: bench.metric_reader(n)(loop) for n in names}
        assert all(isinstance(v, float) and v > 0 for v in values.values()), values
        assert all(values[n] <= 100 for n in names if "_ms." not in n), values
        c, k = loop.c, loop.c["num_experts_per_tok"]
        bound = 0.0
        for call in loop.traced_calls:
            assert call.moe.shape[1:] == (3, c["n_routed_experts"])
            assert (call.moe.sum(-1) % k == 0).all()
            for rows in call.moe.reshape(-1, call.moe.shape[-1]):
                bound += moe_counts.routed_bound_s(c, int(rows.sum()), int((rows > 0).sum()))
        length = sum(e - s for s, e in calls)
        assert values["moe_roofline.dsv2"] == pytest.approx(100 * bound / (0.1 * length))
        assert values["moe_device_ms.dsv2"] == pytest.approx(1000 * 0.1 * length / len(calls))
        steps = ps.spans(loop.trace, *ps.DECODE)
        assert steps and all(any(s <= a <= e for s, e in calls) for a, _ in steps)
        for reader, width, layers, share in (
                ("K7_roofline.dsv2", c["n_shared_experts"] * c["moe_intermediate_size"], 3, 0.05),
                ("K7a_roofline.dsv2", c["ffn_hidden"], 1, 0.025)):
            bound = 0.0
            for call, (s, e) in zip(loop.traced_calls, calls):
                n = sum(1 for a, _ in steps if s <= a <= e) * layers
                bound += n * yardstick.bound_s(*moe_counts.ffn_launch(c, width, call.rows))
            assert values[reader] == pytest.approx(100 * bound / (share * length)), reader
    finally:
        loop.release()
        loop.close()


def test_the_counts_by_hand():
    """DeepSeek-V2-Lite: 2.24 B weights a token outside the embedding and
    the lm-head (its card's "A2.4B" with the lm-head's 0.21 B); a MoE
    layer-forward of 48 rows on 36 experts is bound by its 36 x 17.3 MB."""
    c = {**json.loads((ROOT / "perf_bench" / "configs" / "deepseek-v2-lite.json").read_text())[
        "llm"], **json.loads((ROOT / "perf_bench" / "configs" / "deepseek-v2-lite.json")
                             .read_text())["deepseek_v2"]}
    attn = 2048 * (16 * 192 + 64 + 512) + 512 * 16 * 256 + 16 * 128 * 2048
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    assert moe_counts.active_params(c) == 27 * attn + 3 * 2048 * 10944 + 26 * moe
    assert 2.2e9 < moe_counts.active_params(c) < 2.3e9
    flops, nbytes = moe_counts.routed_launch(c, 48, 36)
    assert nbytes == 2 * (36 * 3 * 2048 * 1408 + 2 * 48 * 2048)
    assert moe_counts.routed_bound_s(c, 48, 36) == pytest.approx(nbytes / 3.35e12)
