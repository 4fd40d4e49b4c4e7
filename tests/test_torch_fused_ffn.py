"""Fused-FFN parity: the port's plain version of K7a against prego_tpu's
fused_ffn_block (interpret mode) and against the unfused JAX sequence
rms_norm -> _feed_forward -> + h, of K7 against prego_tpu's fused_ffn
(interpret mode) and fused_ffn_reference, and of K7q against prego_tpu's
fused_ffn_block_q8 (interpret mode) and the port's unfused int8 sequence,
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prego_tpu.models.llama.model import _feed_forward, rms_norm
from prego_tpu.ops.fused_ffn import fused_ffn as jax_fused_ffn
from prego_tpu.ops.fused_ffn import fused_ffn_block as jax_fused_ffn_block
from prego_tpu.ops.fused_ffn import fused_ffn_block_q8 as jax_fused_ffn_block_q8
from prego_tpu.ops.fused_ffn import fused_ffn_reference as jax_fused_ffn_reference
from prego_tpu.ops.quant import quantize_weight as jax_quantize_weight
from prego_tpu_torch.models.llama.model import _feed_forward as port_feed_forward
from prego_tpu_torch.models.llama.model import fusion_gates
from prego_tpu_torch.ops import fused_ffn as port
from tests.torch_parity import n, t

# f32 on both sides: the Pallas kernel sums W2 over F tiles, the plain
# version in one product; summation order only
TOL = dict(rtol=2e-5, atol=2e-5)
# K7q: the JAX package's bar for the int8 kernel against the unfused int8
# sequence (tests/test_fused_ffn.py): both sides cast xn and a to bf16,
# so an f32 sum taken in another order can move a bf16 rounding
Q8_TOL = dict(rtol=2e-3, atol=2e-3)
EPS = 1e-5


def _inputs(seed, M, D, F):
    rng = np.random.default_rng(seed)
    h = rng.normal(0, 1, (M, D)).astype(np.float32)
    nw = rng.normal(1, 0.1, (D,)).astype(np.float32)
    w13 = rng.normal(0, 0.05, (D, 2 * F)).astype(np.float32)
    w2 = rng.normal(0, 0.05, (F, D)).astype(np.float32)
    return h, nw, w13, w2


@pytest.mark.parametrize("M,D,F", [(1, 128, 256), (8, 256, 512), (5, 128, 384)])
def test_matches_pallas_interpret(M, D, F):
    h, nw, w13, w2 = _inputs(M + F, M, D, F)
    want = jax_fused_ffn_block(
        jnp.asarray(h), jnp.asarray(nw), jnp.asarray(w13), jnp.asarray(w2), EPS,
        f_block=128, interpret=True,
    )
    got = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("M,D,F", [(2, 64, 176), (8, 128, 256)])
def test_matches_unfused_jax_sequence(M, D, F):
    h, nw, w13, w2 = _inputs(3 * M + F, M, D, F)
    jh = jnp.asarray(h)
    want = jh + _feed_forward(
        {"w13": jnp.asarray(w13), "w2": jnp.asarray(w2)}, rms_norm(jh, jnp.asarray(nw), EPS)
    )
    got = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    np.testing.assert_allclose(n(got), n(want), **TOL)


def test_rms_norm_dtype_walk_matches_jax_bf16():
    """bf16: f32 statistics, normed cast to bf16, then the bf16 product
    with the weight. Same roundings on both sides: equal bits."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 64)).astype(np.float32)
    w = rng.normal(1, 0.2, (64,)).astype(np.float32)
    want = rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), EPS)
    got = port.rms_norm(t(x, torch.bfloat16), t(w, torch.bfloat16), EPS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(got), n(want))


def test_wrapper_takes_plain_version_on_cpu():
    h, nw, w13, w2 = _inputs(0, 2, 64, 128)
    before = port.KERNEL.launches
    out = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    assert port.KERNEL.launches == before
    assert torch.equal(out, port.fused_ffn_block_reference(t(h), t(nw), t(w13), t(w2), EPS))


@pytest.mark.parametrize("M,D,F", [(1, 128, 256), (8, 256, 512), (5, 128, 384), (16, 128, 250),
                                   (3, 256, 1024), (2, 128, 200)])
def test_ffn_alone_matches_pallas_interpret_and_reference(M, D, F):
    """K7: x comes in normed; (M, D) f32 out, no residual. On the card, D
    and F multiples of 16 (F 1024) take csrc/fused_ffn_bf16.cu, the others
    (F 250, 200) the first design."""
    x, _, w13, w2 = _inputs(M + 2 * F, M, D, F)
    jx, jw13, jw2 = jnp.asarray(x), jnp.asarray(w13), jnp.asarray(w2)
    want = jax_fused_ffn(jx, jw13, jw2, f_block=128, interpret=True)
    got = port.fused_ffn(t(x), t(w13), t(w2))
    assert got.shape == (M, D) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), **TOL)
    np.testing.assert_allclose(n(got), n(jax_fused_ffn_reference(jx, jw13, jw2)), **TOL)


def test_ffn_alone_is_the_block_without_norm_and_residual():
    """K7a = h + K7(rms_norm(h)) cast to h's dtype, in f32 and in bf16."""
    h, nw, w13, w2 = _inputs(7, 3, 128, 256)
    for dt in (torch.float32, torch.bfloat16):
        args = [t(a, dt) for a in (h, nw, w13, w2)]
        xn = port.rms_norm(args[0], args[1], EPS)
        want = port.fused_ffn_block(*args, EPS)
        assert torch.equal(args[0] + port.fused_ffn(xn, args[2], args[3]).to(dt), want)


def test_ffn_alone_takes_plain_version_on_cpu():
    x, _, w13, w2 = _inputs(1, 2, 64, 128)
    before = port.KERNEL_FFN.launches, port.KERNEL_FFN_FFMA.launches
    out = port.fused_ffn(t(x), t(w13), t(w2))
    assert (port.KERNEL_FFN.launches, port.KERNEL_FFN_FFMA.launches) == before
    assert torch.equal(out, port.fused_ffn_reference(t(x), t(w13), t(w2)))


def _q8_inputs(seed, M, D, F):
    h, nw, w13, w2 = _inputs(seed, M, D, F)
    w13q, w13s = (np.asarray(a) for a in jax_quantize_weight(jnp.asarray(w13)))
    w2q, w2s = (np.asarray(a) for a in jax_quantize_weight(jnp.asarray(w2)))
    return h, nw, w13q, w13s, w2q, w2s


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,D,F", [(8, 256, 512), (1, 128, 256), (3, 128, 384)])
def test_q8_block_matches_pallas_interpret(M, D, F, dtype):
    h, nw, w13q, w13s, w2q, w2s = _q8_inputs(M * 13 + F, M, D, F)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jax_fused_ffn_block_q8(
        jnp.asarray(h).astype(jdt), jnp.asarray(nw).astype(jdt), jnp.asarray(w13q),
        jnp.asarray(w13s), jnp.asarray(w2q), jnp.asarray(w2s), EPS, f_block=128, interpret=True,
    )
    got = port.fused_ffn_block_q8(t(h, tdt), t(nw, tdt), t(w13q), t(w13s), t(w2q), t(w2s), EPS)
    assert got.dtype == tdt and tuple(got.shape) == (M, D)
    np.testing.assert_allclose(n(got), n(want), **Q8_TOL)


def test_q8_block_is_the_unfused_int8_sequence_in_bf16():
    """For a bf16 stream the plain K7q is, bit for bit, what the port's
    model runs without the gate: rms_norm, K4, silu * up, K4, cast, add."""
    h, nw, w13q, w13s, w2q, w2s = (t(a) for a in _q8_inputs(4, 3, 128, 256))
    h, nw = h.to(torch.bfloat16), nw.to(torch.bfloat16)
    got = port.fused_ffn_block_q8(h, nw, w13q, w13s, w2q, w2s, EPS)
    leaves = {"w13": {"q": w13q, "s": w13s}, "w2": {"q": w2q, "s": w2s}}
    x = port.rms_norm(h, nw, EPS)[:, None]
    want = h + port_feed_forward(leaves, x, fusion_gates())[:, 0]
    assert torch.equal(got, want)


def test_q8_block_takes_plain_version_on_cpu():
    args = [t(a) for a in _q8_inputs(2, 2, 64, 128)]
    before = port.KERNEL_Q8.launches, port.KERNEL_Q8_FFMA.launches
    out = port.fused_ffn_block_q8(*args, EPS)
    assert (port.KERNEL_Q8.launches, port.KERNEL_Q8_FFMA.launches) == before
    assert torch.equal(out, port.fused_ffn_block_q8_reference(*args, EPS))


@pytest.mark.parametrize("D,F,sms,want", [
    (4096, 11008, 132, (3, 16)),  # 7B: 43 x 3 up blocks, 8 x 16 down blocks
    (2048, 5632, 132, (6, 33)),   # 1B-class widths
    (64, 176, 132, (2, 6)),       # fewer rows than SMs: a split a stage of 32 rows
    (512, 1024, 132, (16, 32)),
    (512, 1000, 132, None),       # the up columns start at column 1000: no 16-byte boundary
    (5120, 13824, 132, (2, 13)),  # 13B widths: 54 column tiles, two splits of D
    (8192, 28672, 132, None),     # one split of D would stage 8192 rows: past shared memory
    (4104, 11008, 132, None),     # D not a multiple of 16: rows of w2 TMA cannot take
    (4096, 11004, 132, None),     # F not a multiple of 8: rows of w13 TMA cannot take
    (4096, 11008, 32, None),      # 43 column tiles of w13 on 32 SMs: more than one a block
    (256, 1024, 132, (8, 32)),    # 4 up tiles, 1 down tile: a split a stage of 32 rows
])
def test_q8_splits_fill_the_card_once(D, F, sms, want):
    """K7q's and K7's splits: each launch about one block an SM, every
    split at least one stage of rows; None where the redesigns do not take
    the shape (the wrappers then run the first designs)."""
    got = port.ring_splits(D, F, sms)
    assert got == want
    if got is not None:
        P, S = got
        assert -(-F // 256) * P <= max(sms, -(-F // 256))
        assert -(-D // 512) * S <= max(sms, -(-D // 512))
        assert P <= -(-D // 32) and S <= -(-F // 32)


@pytest.mark.parametrize("M,D,F,sms,want", [
    (1, 4096, 14336, 132, ("ring", 1)),    # Mistral-7B: a decode row
    (8, 4096, 14336, 132, ("ring", 1)),
    (9, 4096, 14336, 132, ("ring", 1)),    # two n8 tiles, one weight read
    (32, 4096, 14336, 132, ("ring", 1)),   # the most a step of the cells has
    (33, 4096, 14336, 132, ("ring", 2)),
    (64, 4096, 14336, 132, ("ring", 2)),
    (65, 4096, 14336, 132, ("ring", 3)),
    (1, 2048, 10944, 132, ("ring", 1)),    # DeepSeek-V2-Lite's dense layer 0
    (32, 2048, 10944, 132, ("ring", 1)),
    (40, 2048, 10944, 132, ("ring", 2)),
    (32, 2048, 2816, 132, ("ring", 1)),    # its shared experts (K7)
    (33, 2048, 2816, 132, ("ring", 2)),
    (32, 4096, 11008, 132, ("ring", 1)),   # 7B widths
    (32, 5120, 13824, 132, ("ring", 1)),   # 13B: one call (its entry point launches 25 + 7)
    (33, 5120, 13824, 132, ("ring", 2)),
    (1, 512, 1000, 132, ("first", 1)),     # F 1000: no 16-byte boundary for TMA
    (8, 512, 1000, 132, ("first", 1)),
    (9, 512, 1000, 132, ("first", 2)),     # the first design, 8 rows a launch
    (32, 512, 1000, 132, ("first", 4)),
    (32, 8192, 28672, 132, ("first", 4)),  # a split past shared memory
    (32, 4096, 11008, 32, ("first", 4)),   # more column tiles than SMs
])
def test_ffn_dispatch_rule(M, D, F, sms, want):
    """K7a's and K7's design and launches from (M, D, F, SMs) alone: one
    ring launch for up to 32 rows where the ring takes (D, F), else the
    first design in launches of 8 rows."""
    design, step = port.ffn_design(D, F, sms)
    assert (design, -(-M // step)) == want
    assert (want[0] == "ring") == (port.ring_splits(D, F, sms) is not None)


@pytest.mark.parametrize("D,F", [(4096, 14336), (2048, 10944), (2048, 2816), (5120, 13824),
                                 (64, 176), (256, 1024)])
def test_ring_workspace_holds_every_call(D, F):
    """The workspace of the most rows a ring call takes holds that shape's
    partial sums, a and counters: one set a card serves every shape."""
    design, rows = port.ffn_design(D, F, 132)
    P, S = port.ring_splits(D, F, 132)
    assert (design, rows) == ("ring", port.RING_MAX_ROWS)
    part13, a, part2, counters = port._ring_scratch(F, 132)
    assert P * rows * 2 * F <= part13 and rows * F <= a and S * rows * D <= part2
    assert port._ring_counters(D, F) <= counters


def test_k7a_launch_count_sums_its_ring_and_first_design():
    """chip_smoke.py's count of K7a ("fused_ffn_block") is its ring's
    launches and its first design's together; reset_launches zeroes both."""
    from prego_tpu_torch import ops
    from prego_tpu_torch.ops._cuda import CudaKernel

    saved = {k: k.launches for k in CudaKernel.instances}
    try:
        port.KERNEL.launches, port.KERNEL_BLOCK.launches = 3, 4
        counts = ops.kernel_launches()
        assert counts["fused_ffn_block"] == 7 and set(counts) == set(ops.kernels())
        ops.reset_launches()
        assert port.KERNEL.launches == port.KERNEL_BLOCK.launches == 0
    finally:
        for k, n in saved.items():
            k.launches = n


def test_block_takes_plain_version_on_cpu_at_32_rows():
    h, nw, w13, w2 = _inputs(5, 32, 64, 128)
    before = port.KERNEL.launches, port.KERNEL_BLOCK.launches
    out = port.fused_ffn_block(t(h), t(nw), t(w13), t(w2), EPS)
    assert (port.KERNEL.launches, port.KERNEL_BLOCK.launches) == before
    assert torch.equal(out, port.fused_ffn_block_reference(t(h), t(nw), t(w13), t(w2), EPS))
