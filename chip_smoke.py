"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), builds the four
   CUDA kernels of the path from prego_tpu_torch/csrc with nvcc (one nvcc
   per source, all started together), and holds each against its plain
   PyTorch version at the shapes the main path gives it, in bf16, timing
   both with CUDA events, beside its roofline bound and, where one PyTorch
   call computes the same function, that call's time. The cuDNN GRU layer
   is timed beside the trainable GRU layer as a yardstick.
2. Checks the port against its f32 CPU path: MiniROAD eval at full width
   on two video prefixes, one MiniROAD train step at full width (K1 + K6,
   bf16 stream, dropout 0) on 16 windows, and a 2-layer LLaMA at 7B width.
3. Drives the main path once, through the functions the CLIs call:
   synthetic Assembly101-O-shaped videos (2048-wide rgb features, 86
   classes, a train and a test split) -> MiniROAD training for 2 epochs at
   the Assembly101-O recipe (window 128, batch 16, embedding 2048, hidden
   1024, AdamW lr 1e-4, weight decay 0.05, dropout 0.2), evaluating after
   each epoch and keeping the best checkpoint -> recognition eval of that
   checkpoint with the JSON export -> TI-PREGO aggregation -> anticipation
   with torch-llama at LLaMA-2-7B shape (bf16, random weights from a seed,
   byte tokenizer) -> one-class verdicts and metrics. Every kernel's launch
   count is reset just before this run and must be above 0 after it; the
   trained checkpoint's mAP must beat the untrained model's, and the
   training loss must fall.
4. Times train steps (host clock, and the device busy share of a few under
   torch.profiler) and 7B decode steps at batch 1 and 8.

TF32 is off for matmuls and cuDNN, so f32 products are full f32. Any
failure raises (non-zero exit). The last line is the JSON device record;
before it come a JSON line with each kernel's numbers and the nvidia-smi
line. Needs one CUDA device; refuses to run without one.
"""

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"  # git-ignored: data, checkpoints, results

KERNEL_INFO = {
    "gru_recurrence": ("prego_tpu_torch/csrc/gru.cu", "prego_tpu/ops/gru_pallas.py:96"),
    "gru_bwd": ("prego_tpu_torch/csrc/gru_bwd.cu", "prego_tpu/ops/gru_pallas_vjp.py:116"),
    "decode_attention": ("prego_tpu_torch/csrc/decode_attention.cu",
                         "prego_tpu/ops/decode_attention.py:728"),
    "fused_ffn_block": ("prego_tpu_torch/csrc/fused_ffn.cu", "prego_tpu/ops/fused_ffn.py:131"),
}
# stated tolerances, kernel vs plain version, both bf16 on the card:
TOL = {
    # one bf16 ulp of h (|h| < 1) where an f32 sum of 1024 products, taken
    # in another order, straddles a rounding boundary, carried over 256 frames
    "gru_recurrence": 2.0 ** -6,
    # relative to the largest value: r differs by the f32 order of
    # h_prev.W_hh only; where an f32 sum straddles a bf16 boundary of dHG,
    # one bf16 ulp (2^-8) enters the dh chain, which z and W_hh contract
    "gru_bwd": 2.0 ** -6,
    # p rounded to bf16 against the split's max, not the row's: 2^-9 x |v|
    # (< 5) plus the output's own bf16 rounding
    "decode_attention": 2.0 ** -5,
    # the bf16 output h + y (|out| < 8) rounds one ulp apart when the f32
    # sums over F = 11008 products are taken in another order
    "fused_ffn_block": 2.0 ** -4,
}
# the card's published peaks (H100 SXM, dense): bf16 tensor cores, HBM
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def bound(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def log_case(name, shape, case, tol_note=""):
    log(f"{name} {shape}: max_abs_err {case['max_abs_err']:.3e} (tol {TOL[name]:.3e}{tol_note}), "
        f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), library {case['library_ms']}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    from prego_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    ks = kernels()
    with ThreadPoolExecutor(len(ks)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda k: k.build(), ks.values()))
    for name, k in ks.items():
        regs = [l.strip() for l in k.build_log.splitlines() if "registers" in l]
        log(f"built {name} ({k.library_path().name}): {regs}")
    log(f"kernel build: {time.perf_counter() - t0:.1f}s")


# ---- 1. kernels against their plain versions ----

def check_kernels(dev):
    from prego_tpu_torch.ops import decode_attention as da
    from prego_tpu_torch.ops import fused_ffn as ffn
    from prego_tpu_torch.ops import gru_cuda, gru_cuda_vjp
    from prego_tpu_torch.ops.dense import mm_f32

    rng = np.random.default_rng(0)
    rows = {}

    def mk(scale, *shape, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, dtype)

    # K1 at the recognition eval shapes: 64 videos x 256 frames, E 2048, H 1024
    B, T, E, H = 64, 256, 2048, 1024
    x = mk(1.0, B, T, E, dtype=torch.float32)
    w_ih, w_hh = mk(E ** -0.5, E, 3 * H, dtype=torch.float32), mk(H ** -0.5, H, 3 * H)
    b_ih, b_hh = mk(0.1, 3 * H, dtype=torch.float32), mk(0.1, 3 * H, dtype=torch.float32)
    xg = (mm_f32(x, w_ih) + b_ih).to(torch.bfloat16).transpose(0, 1).contiguous()
    h0 = torch.zeros(B, H, device=dev)
    hs, hT = gru_cuda.gru_recurrence(xg, h0, w_hh, b_hh)
    ref_hs, ref_hT = gru_cuda.gru_recurrence_reference(xg, h0, w_hh, b_hh)
    rows["gru_recurrence"] = dict(
        max_abs_err=max(max_err(hs, ref_hs), max_err(hT, ref_hT)),
        ms=time_ms(lambda: gru_cuda.gru_recurrence(xg, h0, w_hh, b_hh), 10),
        plain_ms=time_ms(lambda: gru_cuda.gru_recurrence_reference(xg, h0, w_hh, b_hh), 3),
        **bound(2 * B * H * 3 * H * T, nbytes(xg, h0, w_hh, b_hh, hs, hT)),
        library_ms=None,  # no one PyTorch call is the recurrence alone: see the cuDNN layer
    )
    log_case("gru_recurrence", f"B={B} T={T} H={H}", rows["gru_recurrence"])

    # K6 at the training shape (T 128, B 16) and at B 64: xg, h_prev, dhs
    # and W_hh bf16 as the trainable layer streams them
    cases = []
    for B_ in (16, 64):
        T_ = 128
        xg6 = mk(1.0, T_, B_, 3 * H)
        hp6 = (torch.rand(T_, B_, H, device=dev) * 1.8 - 0.9).to(torch.bfloat16)
        dhs6 = mk(0.5, T_, B_, H)
        args = (xg6, hp6, dhs6, w_hh, b_hh)
        out = gru_cuda_vjp.gru_bwd(*args)
        ref = gru_cuda_vjp.gru_bwd_reference(*args)
        rel = max(rel_err(o, r) for o, r in zip(out, ref))
        cases.append(dict(
            B=B_, max_abs_err=max(max_err(o, r) for o, r in zip(out, ref)), max_rel_err=rel,
            ms=time_ms(lambda: gru_cuda_vjp.gru_bwd(*args), 10),
            plain_ms=time_ms(lambda: gru_cuda_vjp.gru_bwd_reference(*args), 2),
            # two products a frame: the gate recompute and dHG.W_hh^T
            **bound(2 * 2 * B_ * H * 3 * H * T_, nbytes(*args, *out)),
            library_ms=None,  # no one PyTorch call: see the cuDNN layer
        ))
        log_case("gru_bwd", f"T={T_} B={B_} H={H}", cases[-1], " on max |d| / max |ref|: "
                 f"{rel:.3e}")
        if not rel <= TOL["gru_bwd"]:
            raise AssertionError(f"gru_bwd at B {B_}: relative error {rel} > {TOL['gru_bwd']}")
    rows["gru_bwd"] = {k: v for k, v in cases[0].items() if k not in ("B", "max_rel_err")}
    rows["gru_bwd"]["max_abs_err"] = max(c["max_abs_err"] for c in cases)

    # K2 at the 7B decode shapes: B 8, 32 kv heads, R 1, hd 128, T 512,
    # ragged bounds including 0 and T; and a GQA case with R = 4
    cases = []
    for B_, KV, R in ((8, 32, 1), (8, 8, 4)):
        q, k, v = mk(1.0, B_, KV, R, 128), mk(1.0, B_, KV, 512, 128), mk(1.0, B_, KV, 512, 128)
        valid = torch.tensor([0, 512, 1, 77, 255, 256, 300, 511], dtype=torch.int32, device=dev)
        out = da.decode_attention(q, k, v, valid)
        ref = da.decode_attention_reference(q, k, v, valid)
        if not torch.all(out[0] == 0):
            raise AssertionError("decode_attention: valid_len 0 must give zeros")
        # the same function as one library call: the bounds as a boolean mask
        mask = (torch.arange(512, device=dev)[None, :] < valid[:, None])[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        used = int(valid.sum())  # positions below the bounds: what this data needs read
        cases.append(dict(
            R=R, max_abs_err=max_err(out, ref),
            ms=time_ms(lambda: da.decode_attention(q, k, v, valid), 50),
            plain_ms=time_ms(lambda: da.decode_attention_reference(q, k, v, valid), 20),
            **bound(2 * 2 * used * KV * R * 128,
                    2 * used * KV * 128 * 2 + nbytes(q, valid, out)),
            library_ms=time_ms(lambda: sdpa(q, k, v, attn_mask=mask), 50),
        ))
        log_case("decode_attention", f"B={B_} KV={KV} R={R} T=512", cases[-1])
    rows["decode_attention"] = dict(cases[0], max_abs_err=max(c["max_abs_err"] for c in cases))
    del rows["decode_attention"]["R"]

    # K7a at the 7B FFN shapes: M in {1, 8}, D 4096, F 11008
    cases = []
    D, F = 4096, 11008
    w13, w2 = mk(D ** -0.5, D, 2 * F), mk(F ** -0.5, F, D)
    nw = (mk(0.1, D) + 1).contiguous()
    for M in (1, 8):
        h = mk(1.0, M, D)
        out = ffn.fused_ffn_block(h, nw, w13, w2, 1e-5)
        ref = ffn.fused_ffn_block_reference(h, nw, w13, w2, 1e-5)
        cases.append(dict(
            M=M, max_abs_err=max_err(out, ref),
            ms=time_ms(lambda: ffn.fused_ffn_block(h, nw, w13, w2, 1e-5), 50),
            plain_ms=time_ms(lambda: ffn.fused_ffn_block_reference(h, nw, w13, w2, 1e-5), 50),
            **bound(2 * M * D * 3 * F, nbytes(h, nw, w13, w2, out)),
            library_ms=None,  # PyTorch has no fused norm + SwiGLU FFN call
        ))
        log_case("fused_ffn_block", f"M={M} D={D} F={F}", cases[-1])
    rows["fused_ffn_block"] = dict(cases[0], max_abs_err=max(c["max_abs_err"] for c in cases))
    del rows["fused_ffn_block"]["M"]
    for name, row in rows.items():
        if name != "gru_bwd" and not row["max_abs_err"] <= TOL[name]:
            raise AssertionError(f"{name}: max_abs_err {row['max_abs_err']} > {TOL[name]}")
    return rows


def gru_layer_yardstick(dev):
    """The trainable GRU layer (K1 forward, K6 backward) beside cuDNN's GRU
    layer, both at the training shape and both including the input
    projection; timed only, the port never calls cuDNN's GRU."""
    from prego_tpu_torch.ops.gru_cuda import gru_layer
    from prego_tpu_torch.ops.gru_cuda_vjp import gru_trainable

    B, T, E, H = 16, 128, 2048, 1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.randn(B, T, E, device=dev, generator=gen, requires_grad=True)
    h0 = torch.zeros(B, H, device=dev)
    k = H ** -0.5
    params = {n: ((torch.rand(s, device=dev, generator=gen) * 2 - 1) * k).requires_grad_(True)
              for n, s in (("w_ih", (E, 3 * H)), ("b_ih", (3 * H,)), ("w_hh", (H, 3 * H)),
                           ("b_hh", (3 * H,)))}
    gy = torch.randn(B, T, H, device=dev, generator=gen)

    def port_fwd_bwd():
        hs, _ = gru_trainable(x, h0, params)
        hs.backward(gy)

    cudnn = torch.nn.GRU(E, H, batch_first=True).to(dev, torch.bfloat16)
    cudnn.flatten_parameters()
    xb, gyb = x.detach().to(torch.bfloat16).requires_grad_(True), gy.to(torch.bfloat16)

    def cudnn_fwd_bwd():
        hs, _ = cudnn(xb)
        hs.backward(gyb)

    with torch.no_grad():
        port_fwd = time_ms(lambda: gru_layer(x, h0, params), 10)
        cudnn_fwd = time_ms(lambda: cudnn(xb), 10)
    out = dict(port_fwd_ms=port_fwd, port_fwd_bwd_ms=time_ms(port_fwd_bwd, 10),
               cudnn_bf16_fwd_ms=cudnn_fwd, cudnn_bf16_fwd_bwd_ms=time_ms(cudnn_fwd_bwd, 10))
    log(f"GRU layer at B={B} T={T} E={E} H={H}, input projection included: "
        f"port (K1 fwd, K6 bwd) fwd {out['port_fwd_ms']:.4f} ms, fwd+bwd "
        f"{out['port_fwd_bwd_ms']:.4f} ms; cuDNN bf16 fwd {out['cudnn_bf16_fwd_ms']:.4f} ms, "
        f"fwd+bwd {out['cudnn_bf16_fwd_bwd_ms']:.4f} ms")
    return out


# ---- 2. the port on the card against its f32 CPU path ----

def _to(params, dev):
    """A copy of a MiniROAD parameter dict on ``dev``."""
    return {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()} if isinstance(v, dict)
                else [{kk: vv.to(dev, copy=True) for kk, vv in g.items()} for g in v])
            for k, v in params.items()}


def check_train_step(dev):
    """One MiniROAD train step at full width, dropout 0, on the same 16
    windows: the card (K1 + K6, bf16 stream) against the port's CPU step
    with the same dtype walk (the kernels' plain versions) and against its
    f32 CPU step (the scan)."""
    from prego_tpu_torch.checkpoint.io import tree_leaves
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.core.seed import make_generator
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.train import build_optimizer, make_train_step

    cfg = RecognitionConfig.from_dict({**recognition_config("unused"), "dropout": 0.0})
    model = MiniROAD(cfg)
    init = model.init(make_generator(2))
    rng = np.random.default_rng(2)
    rgb = torch.from_numpy(rng.standard_normal((16, 128, 2048), dtype=np.float32))
    target = torch.from_numpy(np.eye(86, dtype=np.float32)[rng.integers(0, 86, 16)])
    valid = torch.ones(16)
    out = {}
    for where, device, backend in (("card", dev, "pallas_train"),
                                   ("cpu_bf16", torch.device("cpu"), "pallas_train"),
                                   ("cpu_f32", torch.device("cpu"), "scan")):
        params = _to(init, device)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        step = make_train_step(model, build_optimizer(cfg, params), flow_is_zero=True,
                               gru_backend=backend)
        loss = float(step(params, rgb.to(device), None, target.to(device), valid.to(device), None))
        out[where] = (loss, [p.grad.cpu() for p in leaves])
    names = ["cls.b", "cls.w", "embed.b", "embed.w", "gru.b_hh", "gru.b_ih", "gru.w_hh",
             "gru.w_ih", "ln.bias", "ln.scale"]  # the leaves' order
    loss, grads = out["card"]
    res = {}
    for ref_name in ("cpu_bf16", "cpu_f32"):
        ref_loss, ref_grads = out[ref_name]
        res[ref_name] = dict(
            loss_rel=abs(loss - ref_loss) / abs(ref_loss),
            grad_max_rel={n: rel_err(g, r) for n, g, r in zip(names, grads, ref_grads)},
            grad_norm_rel={n: float((g - r).norm() / r.norm())
                           for n, g, r in zip(names, grads, ref_grads)},
        )
    same, f32 = res["cpu_bf16"], res["cpu_f32"]
    worst = {k: {m: max(v[m].values()) for m in ("grad_max_rel", "grad_norm_rel")}
             for k, v in res.items()}
    log(f"MiniROAD train step, 16 windows of 128 at full width, card (K1 + K6) loss {loss:.6f}; "
        f"against the CPU step with the same bf16 walk: loss rel {same['loss_rel']:.3e} "
        f"(tol 1e-4), worst gradient |d| / |ref| {worst['cpu_bf16']['grad_norm_rel']:.3e} "
        f"(tol 2e-2) and max |d| / max |ref| {worst['cpu_bf16']['grad_max_rel']:.3e} (tol 0.5); "
        f"against the CPU f32 step: loss rel {f32['loss_rel']:.3e} (tol 1e-3), "
        f"|d| / |ref| {worst['cpu_f32']['grad_norm_rel']:.3e} (tol 5e-2), "
        f"max |d| / max |ref| {worst['cpu_f32']['grad_max_rel']:.3e} (tol 0.5)")
    log(f"train step gradients by leaf: {json.dumps(res)}")
    # The classifier reads relu(h_T): a unit of h_T near 0 switches its whole
    # last-frame gradient on or off when its value moves across 0, and so
    # changes single gradient elements by up to their size (W_ih's largest
    # change is 0.26 of max |ref| with the plain bf16 walk on the CPU against
    # f32). Hence 0.5 on the largest elementwise change, and the tight
    # bounds on the norms. Against f32, bf16 streaming of xg, W_hh, h, dhs
    # and dHG (2^-9 each) moves the gradients ~2% in norm (measured on the
    # CPU) and the loss by ~1e-5 of itself. With the same dtype walk the
    # card's f32 products x.W_ih still round to bf16 one ulp apart from the
    # CPU's here and there, which moves h_T as bf16 streaming does, units
    # near 0 included: no more than against f32, so 2e-2 in norm.
    if not (same["loss_rel"] <= 1e-4 and worst["cpu_bf16"]["grad_norm_rel"] <= 2e-2
            and worst["cpu_bf16"]["grad_max_rel"] <= 0.5):
        raise AssertionError("the train step on the card disagrees with the plain bf16 step")
    if not (f32["loss_rel"] <= 1e-3 and worst["cpu_f32"]["grad_norm_rel"] <= 5e-2
            and worst["cpu_f32"]["grad_max_rel"] <= 0.5):
        raise AssertionError("the train step on the card disagrees with the CPU f32 step")
    return {"train_step_vs_plain_bf16": worst["cpu_bf16"], "train_step_vs_f32": worst["cpu_f32"]}


def check_against_cpu(dev):
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.core.seed import make_generator
    from prego_tpu_torch.anticipation.llm import fabricated_config
    from prego_tpu_torch.models.llama.model import forward, fuse_projections, init_cache
    from prego_tpu_torch.models.llama.model import init_params
    from prego_tpu_torch.models.miniroad import MiniROAD

    # MiniROAD at the Assembly101-O widths: card (K1, bf16 stream) vs CPU f32
    model = MiniROAD(RecognitionConfig.from_dict(recognition_config("unused")))
    params = model.init(make_generator(1))
    rng = np.random.default_rng(1)
    rgb = torch.from_numpy(rng.standard_normal((2, 512, 2048), dtype=np.float32))
    want = model.forward_full(params, rgb, None, flow_is_zero=True)
    got = model.forward_full(_to(params, dev), rgb.to(dev), None, flow_is_zero=True).cpu()
    rec_err = max_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"MiniROAD card vs CPU f32, 2 x 512 frames: max |d prob| {rec_err:.3e} (tol 5e-2), "
        f"argmax agreement {agree:.4f}")
    if not rec_err <= 5e-2:
        raise AssertionError("MiniROAD on the card disagrees with the CPU f32 path")

    train = check_train_step(dev)

    # LLaMA at 7B width, depth cut to 2 layers: card (bf16, K2 + K7a) vs CPU f32
    cfg = fabricated_config("7b", max_seq_len=512, max_batch_size=8, n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    p_dev = fuse_projections(init_params(cfg, gen, dtype=torch.bfloat16, device=dev))
    p_cpu = {
        "tok_embeddings": p_dev["tok_embeddings"].float().cpu(),
        "norm": p_dev["norm"].float().cpu(),
        "output": p_dev["output"].float().cpu(),
        "layers": [
            {
                "attention": {k: v.float().cpu() for k, v in l["attention"].items()},
                "feed_forward": {k: v.float().cpu() for k, v in l["feed_forward"].items()},
                "attention_norm": l["attention_norm"].float().cpu(),
                "ffn_norm": l["ffn_norm"].float().cpu(),
            }
            for l in p_dev["layers"]
        ],
    }
    toks = torch.from_numpy(rng.integers(0, 256, (2, 20))).long()
    c_dev = init_cache(cfg, 2, torch.bfloat16, dev)
    c_cpu = init_cache(cfg, 2, torch.float32, "cpu")
    worst = 0.0
    for pos, chunk in ((0, toks[:, :16]), (16, toks[:, 16:17]), (17, toks[:, 17:18]),
                       (18, toks[:, 18:19])):
        l_dev, c_dev = forward(p_dev, chunk.to(dev), pos, c_dev, cfg)
        l_cpu, c_cpu = forward(p_cpu, chunk, pos, c_cpu, cfg)
        worst = max(worst, max_err(l_dev.cpu(), l_cpu) / float(l_cpu.abs().max()))
    log(f"LLaMA 7B width x 2 layers, card bf16 vs CPU f32, prefill 16 + 3 decode steps: "
        f"max |d logit| / max |logit| {worst:.3e} (tol 3e-2)")
    if not worst <= 3e-2:
        raise AssertionError("LLaMA on the card disagrees with the CPU f32 path")
    return {"miniroad_max_prob_err": rec_err, "miniroad_argmax_agreement": agree,
            "llama_rel_logit_err": worst, **train}


# ---- 3. the main path ----

def recognition_config(data_root, video_list=""):
    """configs/miniroad_assembly101-O.yaml, as a dict, on synthetic data."""
    return {
        "model": "MiniROAD", "task": "OAD", "loss": "NONUNIFORM", "metric": "AP",
        "data_name": "ASSEMBLY101-O", "root_path": str(data_root),
        "video_list_path": str(video_list), "annotation_type": "target_perframe",
        "rgb_type": "rgb_anet_resnet50", "flow_type": "flow_anet_resnet50",
        "feature_pretrained": "kinetics", "num_classes": 86, "window_size": 128,
        "stride": 4, "embedding_dim": 2048, "hidden_dim": 1024, "num_layers": 1,
        "dropout": 0.2, "optimizer": "AdamW", "lr": 0.0001, "weight_decay": 0.05,
        "batch_size": 16, "test_batch_size": 1, "num_epoch": 2,
        "output_path": str(WORK / "recognition"),
        "eval_output_dir": str(WORK / "pipeline"),
        "eval_output_name": "perframe_predictions.json",
        "gru_backend": "pallas", "train_gru_backend": "pallas_train",
    }


def make_videos(root: Path, n_test=12, n_train=8, num_classes=86, dim=2048, seed=0):
    """Assembly101-O-shaped features on disk: segment-structured one-hot
    targets and class-conditional gaussian rgb, lengths past one chunk;
    the first n_test videos are the test split, the next n_train the train
    split."""
    rng = np.random.default_rng(seed)
    data = root / "ASSEMBLY101-O"
    for sub in ("target_perframe", "rgb_anet_resnet50"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    means = rng.standard_normal((num_classes, dim), dtype=np.float32)
    lengths = {}
    for i in range(n_test + n_train):
        T = int(rng.integers(2100, 3300))
        # steps of 20-200 frames
        n_seg = T // 20 + 1
        labels = np.repeat(rng.integers(0, num_classes, n_seg), rng.integers(20, 200, n_seg))[:T]
        onehot = np.zeros((T, num_classes), np.float32)
        onehot[np.arange(T), labels] = 1.0
        rgb = means[labels] + 0.3 * rng.standard_normal((T, dim), dtype=np.float32)
        vid = f"synth_video_{i:02d}"
        np.save(data / "target_perframe" / f"{vid}.npy", onehot)
        np.save(data / "rgb_anet_resnet50" / f"{vid}.npy", rgb)
        lengths[vid] = T
    vids = list(lengths)
    video_list = root / "video_list.json"
    video_list.write_text(json.dumps({"ASSEMBLY101-O": {
        "class_index": [f"step_{c}" for c in range(num_classes)],
        "train_session_set": vids[n_test:], "test_session_set": vids[:n_test],
    }}))
    return data, video_list, {v: lengths[v] for v in vids[:n_test]}


def check_perframe(raw, lengths):
    if set(raw) != set(lengths):
        raise AssertionError("per-frame JSON does not cover the test videos")
    for vid, rec in raw.items():
        if set(rec) != {"pred", "gt"} or not len(rec["pred"]) == len(rec["gt"]) == lengths[vid]:
            raise AssertionError(f"{vid}: per-frame record malformed")
        if not all(isinstance(v, int) and 0 <= v < 86 for v in rec["pred"]):
            raise AssertionError(f"{vid}: predictions outside the 86 classes")


def untrained_mAP(cfg, dev):
    """The recognition mAP of the untrained model (the init run_train starts from)."""
    from prego_tpu_torch.core.seed import make_generator
    from prego_tpu_torch.data import load_dataset_info, load_feature_store
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.train import Evaluator

    info = load_dataset_info(cfg.video_list_path, cfg.data_name)
    store = load_feature_store(
        root_path=cfg.root_path, vids=info.test_session_set, rgb_type=cfg.rgb_type,
        flow_type=cfg.flow_type, annotation_type=cfg.annotation_type,
        num_classes=cfg.num_classes, training=False, window_size=cfg.window_size,
    )
    model = MiniROAD(cfg)
    mAP, _ = Evaluator(cfg, info.class_index)(model, _to(model.init(make_generator(cfg.seed)), dev),
                                              store)
    return mAP


def run_main_path(dev):
    from prego_tpu_torch.cli import anticipate
    from prego_tpu_torch.cli.pipeline import aggregate_predictions
    from prego_tpu_torch.cli.train import run_eval, run_train
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    data, video_list, lengths = make_videos(WORK / "data")
    cfg = RecognitionConfig.from_dict(recognition_config(data, video_list))
    before = untrained_mAP(cfg, dev)
    agg_path = WORK / "pipeline" / "aggregated.json"
    ant_args = anticipate.parse_args([
        "--llm", "torch-llama", "--fabricated", "7b", "--dataset", "synthcustom",
        "--seqs", str(agg_path), "--results_root", str(WORK / "pipeline" / "results"),
        "--device", str(dev),
    ])
    t_llm = time.perf_counter()
    llm = anticipate.make_llm(ant_args)  # 7B bf16 weights from a seed
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.1f}s: data, untrained mAP {before:.4f}, "
        f"7B weights ({time.perf_counter() - t_llm:.1f}s)")

    for k in kernels().values():
        k.launches = 0
    t1 = time.perf_counter()
    trained = run_train(cfg, str(dev))
    t2 = time.perf_counter()
    cfg.eval = trained.ckpt_path
    _, rec = run_eval(cfg, str(dev))
    t3 = time.perf_counter()
    agg = aggregate_predictions(str(WORK / "pipeline" / "perframe_predictions.json"),
                                str(agg_path))
    steps_before = llm.llama.decode_steps
    result = anticipate.run(ant_args, llm=llm)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {name: k.launches for name, k in kernels().items()}

    raw = json.loads((WORK / "pipeline" / "perframe_predictions.json").read_text())
    check_perframe(raw, lengths)
    if set(agg) != set(raw) or any(len(a["pred"]) != len(a["changes_pred"]) for a in agg.values()):
        raise AssertionError("aggregated sequences malformed")
    m = result.metrics
    n_steps = sum(len(a["pred"]) for a in agg.values())
    if m is None or m["samples"] != n_steps or not 0.0 <= m["accuracy"] <= 1.0:
        raise AssertionError(f"anticipation metrics malformed: {m}")
    if set(result.preds) != set(agg) or not all(isinstance(p, set) for v in result.preds.values() for p in v):
        raise AssertionError("anticipated sets malformed")
    if not all(math.isfinite(x) for x in trained.epoch_losses + [rec["mean_AP"]]):
        raise AssertionError("a training loss or the recognition mAP is not finite")
    if trained.ckpt_path is None or abs(rec["mean_AP"] - trained.best_mAP) > 1e-6:
        raise AssertionError("the eval of the best checkpoint does not give its training mAP")
    if not rec["mean_AP"] > before:
        raise AssertionError(f"training did not help: mAP {rec['mean_AP']} vs untrained {before}")
    if not trained.epoch_losses[-1] < trained.epoch_losses[0]:
        raise AssertionError(f"the training loss did not fall: {trained.epoch_losses}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    st = trained.stats
    report = {
        "test_videos": len(raw), "test_frames": sum(lengths.values()),
        "train_s": t2 - t1, "train_steps": st["steps"], "train_windows": st["windows"],
        "train_steps_per_s": st["steps"] / st["seconds"],
        "train_windows_per_s": st["windows"] / st["seconds"],
        "epoch_losses": trained.epoch_losses, "epoch_mAPs": trained.epoch_mAPs,
        "untrained_mAP": before, "recognition_mAP": rec["mean_AP"],
        "recognition_s": t3 - t2, "recognition_fps": rec["fps"],
        "anticipation_s": t4 - t3, "llm_calls": len(result.llm_latencies),
        "decode_steps": llm.llama.decode_steps - steps_before, "steps_anticipated": n_steps,
        "verdict_metrics": {k: m[k] for k in ("samples", "tp", "fp", "fn", "tn", "accuracy", "f1")},
        "launches": launches,
    }
    log(f"main path: {json.dumps(report)}")
    return llm, cfg, launches, report


# ---- 4. train step and decode step times ----

def _busy_share(prof, wall_ms):
    """Union of the device's activity intervals over the window's wall
    time; None where the profiler saw no device activity."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3 / wall_ms if spans else None


def train_step_ms(cfg, dev, n_timed=20, n_profiled=5):
    """Host-clock ms per train step on windows of the smoke train split,
    and the device busy share of a few steps under torch.profiler."""
    from prego_tpu_torch.checkpoint.io import tree_leaves
    from prego_tpu_torch.core.seed import make_generator
    from prego_tpu_torch.data import WindowSampler, load_dataset_info, load_feature_store
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.train import build_optimizer, make_train_step

    info = load_dataset_info(cfg.video_list_path, cfg.data_name)
    store = load_feature_store(
        root_path=cfg.root_path, vids=info.train_session_set[:2], rgb_type=cfg.rgb_type,
        flow_type=cfg.flow_type, annotation_type=cfg.annotation_type,
        num_classes=cfg.num_classes, training=True, window_size=cfg.window_size,
    )
    sampler = WindowSampler(store, cfg.window_size, cfg.stride)
    np_rng = np.random.default_rng(0)
    sampler.resample(np_rng)
    batches = []
    for b in sampler.iter_batches(cfg.batch_size, rng=np_rng):
        batches.append(b)
        if len(batches) == 4:
            break
    model = MiniROAD(cfg)
    params = _to(model.init(make_generator(cfg.seed)), dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    step = make_train_step(model, build_optimizer(cfg, params), flow_is_zero=True,
                           gru_backend="pallas_train")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def one(i):
        b = batches[i % len(batches)]
        return float(step(params, torch.from_numpy(b.rgb).to(dev), None,
                          torch.from_numpy(np.ascontiguousarray(b.target[:, -1])).to(dev),
                          torch.from_numpy(b.valid).to(dev), gen))

    for i in range(3):
        one(i)
    t0 = time.perf_counter()
    for i in range(n_timed):
        one(i)
    ms = (time.perf_counter() - t0) * 1e3 / n_timed
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_profiled):
            one(i)
        wall = (time.perf_counter() - t0) * 1e3
    busy = _busy_share(prof, wall)
    by_kernel = {}
    for e in prof.key_averages():  # the device's own entries: kernels, copies, sets
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        if dt > 0:
            by_kernel[e.key] = dt / 1e3 / n_profiled
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    log(f"train step (B 16, window 128, full width, K1 + K6): {ms:.3f} ms host clock over "
        f"{n_timed} steps; under the profiler {wall / n_profiled:.3f} ms/step, device busy "
        f"{'not measured' if busy is None else f'{busy:.3f}'}; device ms/step by op: "
        f"{json.dumps({k[:60]: round(v, 4) for k, v in top.items()})}")
    return {"train_step_ms": ms, "train_step_profiled_ms": wall / n_profiled,
            "train_step_device_busy": busy, "train_step_top_device_ms": top}


@torch.no_grad()
def decode_step_ms(llm, dev):
    from prego_tpu_torch.models.llama.model import forward, init_cache

    lm = llm.llama
    out = {}
    for B in (1, 8):
        cache = init_cache(lm.config, B, lm.dtype, dev)
        toks = torch.randint(0, 256, (B, 128), device=dev)
        forward(lm.params, toks, 0, cache, lm.config, lm.rope)  # 128 positions filled
        nxt = toks[:, -1:]
        out[B] = time_ms(lambda: forward(lm.params, nxt, 128, cache, lm.config, lm.rope), 20)
        log(f"7B bf16 decode step, B={B}, at position 128: {out[B]:.3f} ms")
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_kernels()
    rows = check_kernels(dev)
    layer = gru_layer_yardstick(dev)
    cpu = check_against_cpu(dev)
    llm, cfg, launches, report = run_main_path(dev)
    train = train_step_ms(cfg, dev)
    decode = decode_step_ms(llm, dev)
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")
    jax_package = sorted(m for m in sys.modules if m == "prego_tpu" or m.startswith("prego_tpu."))
    if jax_package:
        raise AssertionError(f"the port loaded modules of the JAX package: {jax_package}")

    log(json.dumps({"summary": {**report, "cpu_checks": cpu, "gru_layer": layer, **train,
                                "decode_ms_per_step": {str(b): v for b, v in decode.items()},
                                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                                "total_s": time.perf_counter() - t_start}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name], **rows[name]}
        for name in KERNEL_INFO
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
