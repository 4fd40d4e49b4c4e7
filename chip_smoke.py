"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

  python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit), builds the three
   CUDA kernels of the path from prego_tpu_torch/csrc with nvcc, and holds
   each against its plain PyTorch version at the shapes the main path
   gives it, in bf16, timing both with CUDA events.
2. Checks the port against its f32 CPU path on small inputs: MiniROAD at
   full width on two video prefixes, and a 2-layer LLaMA at 7B width.
3. Drives the main path once, through the functions the CLIs call:
   synthetic Assembly101-O-shaped videos (2048-wide rgb features, 86
   classes, lengths past one 2048-frame chunk) -> MiniROAD recognition
   eval at the Assembly101-O recipe (embedding 2048, hidden 1024) from a
   checkpoint the port writes in the JAX package's format -> TI-PREGO
   aggregation -> anticipation with torch-llama at LLaMA-2-7B shape (bf16,
   random weights from a seed, byte tokenizer) -> one-class verdicts and
   metrics. Every kernel's launch count is reset just before this run and
   must be above 0 after it.
4. Times 7B decode steps at batch 1 and 8.

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"  # git-ignored: data, checkpoint, results

KERNEL_INFO = {
    "gru_recurrence": ("prego_tpu_torch/csrc/gru.cu", "prego_tpu/ops/gru_pallas.py:96"),
    "decode_attention": ("prego_tpu_torch/csrc/decode_attention.cu",
                         "prego_tpu/ops/decode_attention.py:728"),
    "fused_ffn_block": ("prego_tpu_torch/csrc/fused_ffn.cu", "prego_tpu/ops/fused_ffn.py:131"),
}
# stated tolerances, kernel vs plain version, both bf16 on the card:
TOL = {
    # one bf16 ulp of h (|h| < 1) where an f32 sum of 1024 products, taken
    # in another order, straddles a rounding boundary, carried over 256 frames
    "gru_recurrence": 2.0 ** -6,
    # p rounded to bf16 against the split's max, not the row's: 2^-9 x |v|
    # (< 5) plus the output's own bf16 rounding
    "decode_attention": 2.0 ** -5,
    # the bf16 output h + y (|out| < 8) rounds one ulp apart when the f32
    # sums over F = 11008 products are taken in another order
    "fused_ffn_block": 2.0 ** -4,
}


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


def log_case(name, shape, case):
    log(f"{name} {shape}: max_abs_err {case['max_abs_err']:.3e} (tol {TOL[name]:.3e}), "
        f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---- 1. kernels against their plain versions ----

def check_kernels(dev):
    from prego_tpu_torch.ops import decode_attention as da
    from prego_tpu_torch.ops import fused_ffn as ffn
    from prego_tpu_torch.ops import gru_cuda
    from prego_tpu_torch.ops.dense import mm_f32

    rng = np.random.default_rng(0)
    rows = {}

    def mk(scale, *shape, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, dtype)

    # K1 at the recognition shapes: 64 videos x 256 frames, E 2048, H 1024
    B, T, E, H = 64, 256, 2048, 1024
    x = mk(1.0, B, T, E, dtype=torch.float32)
    w_ih, w_hh = mk(E ** -0.5, E, 3 * H, dtype=torch.float32), mk(H ** -0.5, H, 3 * H)
    b_ih, b_hh = mk(0.1, 3 * H, dtype=torch.float32), mk(0.1, 3 * H, dtype=torch.float32)
    xg = (mm_f32(x, w_ih) + b_ih).to(torch.bfloat16).transpose(0, 1).contiguous()
    h0 = torch.zeros(B, H, device=dev)
    hs, hT = gru_cuda.gru_recurrence(xg, h0, w_hh, b_hh)
    ref_hs, ref_hT = gru_cuda.gru_recurrence_reference(xg, h0, w_hh, b_hh)
    err = max(max_err(hs, ref_hs), max_err(hT, ref_hT))
    rows["gru_recurrence"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: gru_cuda.gru_recurrence(xg, h0, w_hh, b_hh), 10),
        plain_ms=time_ms(lambda: gru_cuda.gru_recurrence_reference(xg, h0, w_hh, b_hh), 3),
    )
    log_case("gru_recurrence", f"B={B} T={T} H={H}", rows["gru_recurrence"])

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
        cases.append(dict(
            R=R, max_abs_err=max_err(out, ref),
            ms=time_ms(lambda: da.decode_attention(q, k, v, valid), 50),
            plain_ms=time_ms(lambda: da.decode_attention_reference(q, k, v, valid), 20),
        ))
        log_case("decode_attention", f"B={B_} KV={KV} R={R} T=512", cases[-1])
    rows["decode_attention"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
    )

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
        ))
        log_case("fused_ffn_block", f"M={M} D={D} F={F}", cases[-1])
    rows["fused_ffn_block"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
    )
    for name, row in rows.items():
        if not row["max_abs_err"] <= TOL[name]:
            raise AssertionError(f"{name}: max_abs_err {row['max_abs_err']} > {TOL[name]}")
    return rows


# ---- 2. the port on the card against its f32 CPU path, small inputs ----

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
    dparams = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict)
                   else [{kk: vv.to(dev) for kk, vv in g.items()} for g in v])
               for k, v in params.items()}
    got = model.forward_full(dparams, rgb.to(dev), None, flow_is_zero=True).cpu()
    rec_err = max_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"MiniROAD card vs CPU f32, 2 x 512 frames: max |d prob| {rec_err:.3e} (tol 5e-2), "
        f"argmax agreement {agree:.4f}")
    if not rec_err <= 5e-2:
        raise AssertionError("MiniROAD on the card disagrees with the CPU f32 path")

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
            "llama_rel_logit_err": worst}


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
        "batch_size": 16, "test_batch_size": 1, "num_epoch": 10,
        "output_path": str(WORK / "recognition"),
        "eval_output_dir": str(WORK / "pipeline"),
        "eval_output_name": "perframe_predictions.json",
        "gru_backend": "pallas",
    }


def make_videos(root: Path, n_videos=12, num_classes=86, dim=2048, seed=0):
    """Assembly101-O-shaped features on disk: segment-structured one-hot
    targets and class-conditional gaussian rgb, lengths past one chunk."""
    rng = np.random.default_rng(seed)
    data = root / "ASSEMBLY101-O"
    for sub in ("target_perframe", "rgb_anet_resnet50"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    means = rng.standard_normal((num_classes, dim), dtype=np.float32)
    lengths = {}
    for i in range(n_videos):
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
    video_list = root / "video_list.json"
    video_list.write_text(json.dumps({"ASSEMBLY101-O": {
        "class_index": [f"step_{c}" for c in range(num_classes)],
        "train_session_set": [], "test_session_set": list(lengths),
    }}))
    return data, video_list, lengths


def check_perframe(raw, lengths):
    if set(raw) != set(lengths):
        raise AssertionError("per-frame JSON does not cover the test videos")
    for vid, rec in raw.items():
        if set(rec) != {"pred", "gt"} or not len(rec["pred"]) == len(rec["gt"]) == lengths[vid]:
            raise AssertionError(f"{vid}: per-frame record malformed")
        if not all(isinstance(v, int) and 0 <= v < 86 for v in rec["pred"]):
            raise AssertionError(f"{vid}: predictions outside the 86 classes")


def run_main_path(dev):
    from prego_tpu_torch.checkpoint import save_checkpoint
    from prego_tpu_torch.cli import anticipate
    from prego_tpu_torch.cli.pipeline import aggregate_predictions
    from prego_tpu_torch.cli.train import run_eval
    from prego_tpu_torch.core import RecognitionConfig
    from prego_tpu_torch.core.seed import make_generator
    from prego_tpu_torch.models.miniroad import MiniROAD
    from prego_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    data, video_list, lengths = make_videos(WORK / "data")
    cfg = RecognitionConfig.from_dict(recognition_config(data, video_list))
    ckpt = WORK / "miniroad_init.ckpt"
    save_checkpoint(str(ckpt), MiniROAD(cfg).init(make_generator(0)))
    cfg.eval = str(ckpt)
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
    log(f"set-up {setup_s:.1f}s: {sum(lengths.values())} frames of data, checkpoint, "
        f"7B weights ({time.perf_counter() - t_llm:.1f}s)")

    for k in kernels().values():
        k.launches = 0
    t1 = time.perf_counter()
    _, rec = run_eval(cfg, str(dev))
    t2 = time.perf_counter()
    agg = aggregate_predictions(str(WORK / "pipeline" / "perframe_predictions.json"),
                                str(agg_path))
    steps_before = llm.llama.decode_steps
    result = anticipate.run(ant_args, llm=llm)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
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
    if not math.isfinite(rec["mean_AP"]):
        raise AssertionError("recognition mAP is not finite")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    report = {
        "videos": len(raw), "frames": sum(lengths.values()),
        "recognition_s": t2 - t1, "recognition_fps": rec["fps"], "recognition_mAP": rec["mean_AP"],
        "anticipation_s": t3 - t2, "llm_calls": len(result.llm_latencies),
        "decode_steps": llm.llama.decode_steps - steps_before, "steps_anticipated": n_steps,
        "verdict_metrics": {k: m[k] for k in ("samples", "tp", "fp", "fn", "tn", "accuracy", "f1")},
        "launches": launches,
    }
    log(f"main path: {json.dumps(report)}")
    return llm, launches, report


# ---- 4. decode step time at 7B ----

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
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from prego_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    for name, k in kernels().items():
        k.build()
        regs = [l.strip() for l in k.build_log.splitlines() if "registers" in l]
        log(f"built {name} ({k.library_path().name}): {regs}")
    log(f"kernel build: {time.perf_counter() - t0:.1f}s")

    rows = check_kernels(dev)
    cpu = check_against_cpu(dev)
    llm, launches, report = run_main_path(dev)
    decode = decode_step_ms(llm, dev)
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")

    log(json.dumps({"summary": {**report, "cpu_checks": cpu,
                                "decode_ms_per_step": {str(b): v for b, v in decode.items()},
                                "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}}))
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
