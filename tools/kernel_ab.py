"""Time the port's K2, K4, K5, K3, K8, K8u, K9, K7q, K7a, K7, K1 and K6 from
one checkout on the card, under chip_smoke.py's yardsticks, to compare two
designs within one run.

  python3 tools/kernel_ab.py --root DIR [--kernels K2,K4,K5,K3,K8,K8u,K9,K7q,K7a,K7,K1,K6]
      [--tile-rows] [--k5-cluster] [--k1-split] [--k6-split] [--no-check]

DIR is the root of a checkout of the repo: this one, or an earlier commit
unpacked with ``git archive`` into a git-ignored directory. Its
prego_tpu_torch is imported, and its kernels are built under DIR. One
process imports one checkout, so run the two in turns, A B B A:

  mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
  for r in build/parent . . build/parent; do python3 tools/kernel_ab.py --root $r; done

Cases, with inputs made from a seed and rotated past the 50 MB L2 as a
decode step reads them; each kernel and its library call timed on the host
clock (back-to-back calls, CUDA events) and on the device (torch.profiler),
with chip_smoke.py's helpers:
  K2  B 8, T 512, hd 128, chip_smoke.py's bounds: KV 32, R 1 and KV 8, R 4
      (SDPA with a boolean mask beside it)
  K4  the five 7B projections at M 1 and 8; w13 and wo at M 512 and wqkv
      at M 256 (torch.mm on bf16 weights beside it)
  K5  the five 7B projections at M 1 and 8; w13 at M 64, 512 and 2048,
      wqkv at M 256 and wo at M 512 (torch._int_mm alone, and with the two
      scales, beside it; rows padded to 32 below 17)
  K3  B 8, T 512, hd 128, chip_smoke.py's bounds: KV 32, R 1 and KV 8, R 4
      over an int8 cache (SDPA on the dequantized bf16 cache and K2 on that
      bf16 cache beside it; K3's device time also by kernel)
  K8  chip_smoke.py's 1B cases (KV 16, R 1, hd 128, T 512, D 2048): B 1 at
      bound 300 and B 8 at its ragged bounds, with and without the residual
      (the unfused K2 + torch.mm + cast + add beside it)
  K8u the same at pos = bound - 1 (the unfused cache write + K2 + torch.mm
      + add beside it); its caches' bytes go into its digest
  K9  the 7B norm + wqkv (bf16 out), wo + residual and norm + lm-head (f32
      out) at M 1 to 8, and the lm-head at M 64 (the unfused rms_norm + K4
      + cast, or K4 + cast + add, beside it)
  K7q the 7B int8 FFN sub-layer (D 4096, F 11008) at M 1 to 8 (the unfused
      rms_norm + K4 + silu * up + K4 + add beside it)
  K7a the 7B bf16 FFN sub-layer at M 1 and 8, Mistral-7B's (D 4096, F
      14336) at M 1, 8, 16, 24 and 32, DeepSeek-V2-Lite's dense layer 0 (D
      2048, F 10944) at M 8 and 32
  K7  the 1B FFN (D 2048, F 5632) at M 1 and 8, the 7B FFN (D 4096, F
      11008) at M 1, DeepSeek-V2-Lite's shared experts (D 2048, F 2816) at
      M 8 and 32
K7a's and K7's cases also give their bound (``bound_ms``: the weights read
once, the rows in and out, at 3.35 TB/s).
  K1  the GRU recurrence at H 1024: B 64, T 256 (recognition eval), B 16,
      T 128 (training) and B 128, T 512; us a frame beside the device time
  K6  the GRU backward recurrence at H 1024, T 128: B 16 (training) and
      B 64; us a frame beside the device time
K8, K8u, K9, K7q, K7a, K7, K1 and K6 also give each kernel's device time
and a SHA-256 of their output's bytes (``sha256``), so that two
checkouts' results can be held equal bit for bit.
``--tile-rows`` (this checkout only) also times K4's wgmma tile kernel
with tiles of 128 and of 256 rows (tools/w8_tile_rows.cu) at the 7B
shapes where w8::launch_tile takes 128. ``--k5-cluster`` (this checkout
only) also times K5's streaming GEMV with its splits summed in a thread
block cluster (tools/w8a8_gemv_cluster.cu) at the decode shapes.
``--k1-split`` also runs K1's design of dc1e0f6 with clock64() stamps
(tools/gru_split.cu) at K1's three shapes, for the split of a frame
between the copy of h, the product, the gate math and the grid barrier,
and times T empty exchanges over the same 128 CTAs, by grid barrier and by
K1's split arrive and wait: the chain floor of a frame. ``--k6-split``
runs K6's design of 09bfd55 with clock64() stamps (tools/gru_bwd_split.cu)
at K6's two shapes, for the split of a frame between staging h_prev, the
gate product, the gate math, the grid barrier, staging dHG and the dh
product. ``--no-check`` times K7q's, K7's, K1's and K6's cases without
holding them against their plain versions: for copies of a tree with a
part of a kernel taken out, to read what that part costs.

Prints one JSON object a case, each beside the card's nvidia-smi line.
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CHECK = True  # hold K7q's, K7's, K1's and K6's cases to their plain versions (--no-check: not)


def load_smoke():
    """chip_smoke.py's helpers, from this checkout whatever DIR is. It
    imports the device-time helpers of prego_tpu_torch/core/profiling.py:
    where DIR's package predates that module, this checkout's is used."""
    import prego_tpu_torch.core

    name = "prego_tpu_torch.core.profiling"
    if importlib.util.find_spec(name) is None:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "prego_tpu_torch" / "core" / "profiling.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_cases(sm, dev):
    from prego_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    valid = torch.tensor([0, 512, 1, 77, 255, 256, 300, 511], dtype=torch.int32, device=dev)
    mask = (torch.arange(512, device=dev)[None, :] < valid[:, None])[:, None, None, :]
    for KV, R in ((32, 1), (8, 4)):
        sets = sm.copies_past_l2(lambda: tuple(
            torch.randn(*shape, device=dev, generator=gen).to(torch.bfloat16)
            for shape in ((8, KV, R, 128), (8, KV, 512, 128), (8, KV, 512, 128))),
            2 * 8 * KV * 512 * 128 * 2)
        k2 = lambda q, k, v: da.decode_attention(q, k, v, valid)
        lib = lambda q, k, v: sdpa(q, k, v, attn_mask=mask)
        err = sm.max_err(k2(*sets[0]), da.decode_attention_reference(*sets[0], valid))
        if not err <= sm.TOL["decode_attention"]:
            raise AssertionError(f"K2 KV {KV} R {R}: max_abs_err {err}")
        yield dict(kernel="K2", shape=f"B 8 KV {KV} R {R} T 512", max_abs_err=err,
                   ms=sm.time_ms_cycle(k2, sets, 50),
                   device_ms=sm.device_ms_cycle(k2, sets, what="K2"),
                   library_ms=sm.time_ms_cycle(lib, sets, 50),
                   library_device_ms=sm.device_ms_cycle(lib, sets, what="SDPA"))


def k4_inputs(gen, dev, M, K, N):
    from prego_tpu_torch.ops import quant

    def make():
        x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
        q, s = quant.quantize_weight(torch.randn(K, N, device=dev, generator=gen) * K ** -0.5)
        return x, q, s
    return make


def k4_cases(sm, dev):
    from prego_tpu_torch.ops import quant

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    mm = lambda a, w: torch.mm(a, w, out_dtype=torch.float32)
    shapes = [(M, name, K, N) for M in (1, 8) for name, (K, N) in sm.PROJ_7B.items()]
    shapes += [(512, "w13", *sm.PROJ_7B["w13"]), (256, "wqkv", *sm.PROJ_7B["wqkv"]),
               (512, "wo", *sm.PROJ_7B["wo"])]
    for M, name, K, N in shapes:
        sets = sm.copies_past_l2(k4_inputs(gen, dev, M, K, N), K * N)
        wd = [(x, (q.float() * s).to(torch.bfloat16)) for x, q, s in sets]
        err = sm.max_err(quant.int8_matmul(*sets[0]), quant.int8_matmul_reference(*sets[0]))
        if not err <= sm.TOL["int8_matmul"]:
            raise AssertionError(f"K4 {name} M {M}: max_abs_err {err}")
        iters = 20 if M > 8 else 50
        yield dict(kernel="K4", shape=f"{name} M {M}", max_abs_err=err,
                   ms=sm.time_ms_cycle(quant.int8_matmul, sets, iters),
                   device_ms=sm.device_ms_cycle(quant.int8_matmul, sets, what="K4"),
                   library_ms=sm.time_ms_cycle(mm, wd, iters),
                   library_device_ms=sm.device_ms_cycle(mm, wd, what="torch.mm"))


def k5_cases(sm, dev, cluster=False):
    from prego_tpu_torch.ops import quant

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    shapes = [(M, name, *sm.PROJ_7B[name]) for M in (1, 8) for name in sm.PROJ_7B]
    shapes += [(M, "w13", *sm.PROJ_7B["w13"]) for M in (64, 512, 2048)]
    shapes += [(256, "wqkv", *sm.PROJ_7B["wqkv"]), (512, "wo", *sm.PROJ_7B["wo"])]
    gemv_cluster = k5_cluster_kernel() if cluster else None
    for M, name, K, N in shapes:
        def make():
            x = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            q, s = quant.quantize_weight(torch.randn(K, N, device=dev, generator=gen) * K ** -0.5)
            xq, xs = quant.quantize_activations(x)
            return xq, xs, q, s
        sets = sm.copies_past_l2(make, K * N)
        y = quant.int8xint8_matmul(*sets[0])
        err = sm.max_err(y, quant.int8xint8_matmul_reference(*sets[0]))
        if not err <= sm.TOL["int8xint8_matmul"]:
            raise AssertionError(f"K5 {name} M {M}: max_abs_err {err}")
        pad = max(0, 32 - M) if M <= 16 else 0  # torch._int_mm takes more than 16 rows
        lib = [(torch.cat([a, a.new_zeros(pad, K)]), torch.cat([sa, sa.new_ones(pad, 1)]), w, sw)
               for a, sa, w, sw in sets]
        int_mm = lambda a, sa, w, sw: torch._int_mm(a, w)
        scaled = lambda a, sa, w, sw: torch._int_mm(a, w).float() * sa * sw[0]
        iters = 20 if M > 8 else 50
        case = dict(kernel="K5", shape=f"{name} M {M}", max_abs_err=err,
                    ms=sm.time_ms_cycle(quant.int8xint8_matmul, sets, iters),
                    device_ms=sm.device_ms_cycle(quant.int8xint8_matmul, sets, what="K5"),
                    library_rows=M + pad,
                    int_mm_ms=sm.time_ms_cycle(int_mm, lib, iters),
                    int_mm_device_ms=sm.device_ms_cycle(int_mm, lib, what="torch._int_mm"),
                    library_ms=sm.time_ms_cycle(scaled, lib, iters),
                    library_device_ms=sm.device_ms_cycle(scaled, lib, what="_int_mm + scales"))
        if gemv_cluster is not None and M <= 8:
            if not torch.equal(gemv_cluster(*sets[0]), y):
                raise AssertionError(f"K5's cluster GEMV at {name} M {M} differs from K5")
            case["cluster_gemv"] = dict(
                ms=sm.time_ms_cycle(gemv_cluster, sets, iters),
                device_ms=sm.device_ms_cycle(gemv_cluster, sets, what="K5 cluster GEMV"))
        yield case


def k5_cluster_kernel():
    """K5's streaming GEMV with a cluster reduce (tools/w8a8_gemv_cluster.cu)."""
    from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, stream_ptr

    kernel = CudaKernel("w8a8_gemv_cluster", str(REPO / "tools" / "w8a8_gemv_cluster.cu"),
                        {"prego_w8a8_gemv_cluster": [c_ptr] * 5 + [c_int] * 3 + [c_ptr]})

    def run(xq, xs, q, s):
        M, K = xq.shape
        N = q.shape[1]
        out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
        kernel.call("prego_w8a8_gemv_cluster", xq.data_ptr(), xs.data_ptr(), q.data_ptr(),
                    s.data_ptr(), out.data_ptr(), M, K, N, stream_ptr(xq.device))
        return out
    return run


def device_ms_by_kernel(sm, fn, arg_sets, iters=20):
    """Each kernel's own device time a call of ``fn`` over ``arg_sets`` in
    turn, by kernel name, from one torch.profiler session."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    spans = {}
    for name, start, end in sm.device_spans(prof):
        spans[name[:80]] = spans.get(name[:80], 0.0) + (end - start) / 1e3 / iters
    return spans


def k3_cases(sm, dev):
    from prego_tpu_torch.models.llama.model import _kv_dequant, _kv_quantize
    from prego_tpu_torch.ops import decode_attention as da
    from prego_tpu_torch.ops import decode_attention_q8 as da8

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    bf16 = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    valid = torch.tensor([0, 512, 1, 77, 255, 256, 300, 511], dtype=torch.int32, device=dev)
    mask = (torch.arange(512, device=dev)[None, :] < valid[:, None])[:, None, None, :]

    for KV, R in ((32, 1), (8, 4)):
        def make():
            q = torch.randn(8, KV, R, 128, device=dev, generator=gen).to(bf16)
            kq, ks = _kv_quantize(torch.randn(8, KV, 512, 128, device=dev, generator=gen))
            vq, vs = _kv_quantize(torch.randn(8, KV, 512, 128, device=dev, generator=gen))
            return q, kq, ks, vq, vs
        sets = sm.copies_past_l2(make, 2 * 8 * KV * 512 * 132)
        deq = [(q, _kv_dequant({"q": kq, "s": ks}, bf16), _kv_dequant({"q": vq, "s": vs}, bf16))
               for q, kq, ks, vq, vs in sets]
        k3 = lambda *a: da8.decode_attention_q8(*a, valid)
        k2 = lambda q, k, v: da.decode_attention(q, k, v, valid)
        lib = lambda q, k, v: sdpa(q, k, v, attn_mask=mask)
        err = sm.max_err(k3(*sets[0]), da8.decode_attention_q8_reference(*sets[0], valid))
        if not err <= sm.TOL["decode_attention_q8"]:
            raise AssertionError(f"K3 KV {KV} R {R}: max_abs_err {err}")
        yield dict(kernel="K3", shape=f"B 8 KV {KV} R {R} T 512", max_abs_err=err,
                   ms=sm.time_ms_cycle(k3, sets, 50),
                   device_ms=sm.device_ms_cycle(k3, sets, what="K3"),
                   device_by_kernel=device_ms_by_kernel(sm, k3, sets),
                   k2_bf16_ms=sm.time_ms_cycle(k2, deq, 50),
                   k2_bf16_device_ms=sm.device_ms_cycle(k2, deq, what="K2 on the bf16 cache"),
                   library_ms=sm.time_ms_cycle(lib, deq, 50),
                   library_device_ms=sm.device_ms_cycle(lib, deq, what="SDPA"))


def digest(*tensors):
    """The first 16 hex digits of a SHA-256 over the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(sm, name, fn, sets, iters, unfused=None):
    """A case's host clock, device time (all kernels, and by kernel) and,
    where given, the unfused sequence's host clock and device time."""
    case = dict(ms=sm.time_ms_cycle(fn, sets, iters),
                device_ms=sm.device_ms_cycle(fn, sets, what=name),
                device_by_kernel=device_ms_by_kernel(sm, fn, sets))
    if unfused is not None:
        case.update(unfused_ms=sm.time_ms_cycle(unfused, sets, iters),
                    unfused_device_ms=sm.device_ms_cycle(unfused, sets, what=f"{name} unfused"))
    return case


def k8_cases(sm, dev, upd):
    """K8 (both bodies) or K8u at chip_smoke.py's 1B cases."""
    from prego_tpu_torch.ops import decode_attention as da
    from prego_tpu_torch.ops import decode_attention_wo as dwo
    from prego_tpu_torch.ops.dense import mm_f32

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    bf16 = torch.bfloat16
    KV, R, hd, T, D = 16, 1, 128, 512, 2048
    H = KV * R
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf16)
    for vl in ([300], [0, 512, 1, 77, 255, 256, 300, 511]):
        B = len(vl)
        valid = torch.tensor(vl, dtype=torch.int32, device=dev)
        pos = (valid - 1).clamp(min=0)

        def make():
            qkv = rn(B, 1, (H + 2 * KV) * hd)  # the new K/V as views, as the model hands them
            return (rn(B, KV, R, hd), rn(B, KV, T, hd), rn(B, KV, T, hd),
                    rn(H * hd, D, scale=(H * hd) ** -0.5), rn(B, 1, D),
                    qkv[..., H * hd : (H + KV) * hd].reshape(B, 1, KV, hd).transpose(1, 2),
                    qkv[..., (H + KV) * hd :].reshape(B, 1, KV, hd).transpose(1, 2))
        sets = sm.copies_past_l2(make, 2 * B * KV * T * hd * 2 + H * hd * D * 2)
        q, k, v, wo, h, k_new, v_new = sets[0]

        def attend(q, k, v, bound):
            return da.decode_attention(q, k, v, bound).reshape(B, 1, H * hd)

        if upd:
            def k8u(q, k, v, wo, h, kn, vn):
                return dwo.decode_attention_wo_res_upd(q, h, kn, vn, k, v, pos, wo)[0]

            def unfused(q, k, v, wo, h, kn, vn):
                dwo.write_token_kv(kn, vn, k, v, pos)
                return h + mm_f32(attend(q, k, v, pos + 1), wo).to(h.dtype)
            ck, cv = k.clone(), v.clone()
            out = k8u(q, ck, cv, wo, h, k_new, v_new)
            want, _, _ = dwo.decode_attention_wo_res_upd_reference(
                q, h, k_new, v_new, k.clone(), v.clone(), pos, wo)
            err = sm.max_err(out, want)
            if not err <= sm.TOL["decode_attention_wo_res_upd"]:
                raise AssertionError(f"K8u B {B}: max_abs_err {err}")
            yield dict(kernel="K8u", shape=f"B {B} KV {KV} hd {hd} T {T} D {D}",
                       max_abs_err=err, sha256=digest(out, ck, cv),
                       **timed(sm, f"K8u B {B}", k8u, sets, 50, unfused))
            continue
        for res in (True, False):
            def k8(q, k, v, wo, h, *_):
                return dwo.decode_attention_wo(q, k, v, valid, wo, residual=h if res else None)

            def unfused(q, k, v, wo, h, *_):
                y = mm_f32(attend(q, k, v, valid), wo)
                return h + y.to(h.dtype) if res else y
            out = k8(*sets[0])
            err = sm.max_err(out, dwo.decode_attention_wo_reference(
                q, k, v, valid, wo, residual=h if res else None))
            if not err <= sm.TOL["decode_attention_wo"]:
                raise AssertionError(f"K8 B {B} residual {res}: max_abs_err {err}")
            yield dict(kernel="K8", shape=f"B {B} KV {KV} hd {hd} T {T} D {D}"
                       + (" residual" if res else ""), max_abs_err=err, sha256=digest(out),
                       **timed(sm, f"K8 B {B}{' res' if res else ''}", k8, sets, 50, unfused))


def k9_cases(sm, dev):
    """K9 at chip_smoke.py's 7B decode and prefill cases."""
    from prego_tpu_torch.ops import fused_dense as fd
    from prego_tpu_torch.ops import fused_ffn as ffn
    from prego_tpu_torch.ops import quant

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    bf16, eps = torch.bfloat16, 1e-5
    rn = lambda *shape, scale=1.0: torch.randn(*shape, device=dev, generator=gen) * scale
    sites = {"wqkv": ("norm", *sm.PROJ_7B["wqkv"], bf16), "wo": ("residual", *sm.PROJ_7B["wo"], bf16),
             "lm_head": ("norm", *sm.PROJ_7B["lm_head"], torch.float32)}
    for site, M in [(site, M) for M in range(1, 9) for site in sites] + [("lm_head", 64)]:
        mode, K, N, out_dtype = sites[site]

        def make():
            q, s = quant.quantize_weight(rn(K, N, scale=K ** -0.5))
            return (rn(M, K).to(bf16), q, s, (rn(K, scale=0.1) + 1).to(bf16), rn(M, N).to(bf16))
        sets = sm.copies_past_l2(make, K * N)
        if mode == "norm":
            kw = lambda nw, res: dict(norm_weight=nw, eps=eps, out_dtype=out_dtype)

            def unfused(x, q, s, nw, res):
                return quant.int8_matmul(ffn.rms_norm(x, nw, eps), q, s).to(out_dtype)
        else:
            kw = lambda nw, res: dict(residual=res)

            def unfused(x, q, s, nw, res):
                return res + quant.int8_matmul(x, q, s).to(bf16)

        def k9(x, q, s, nw, res):
            return fd.fused_dense_q8(x, q, s, **kw(nw, res))
        out = k9(*sets[0])
        x, q, s, nw, res = sets[0]
        err = sm.max_err(out, fd.fused_dense_q8_reference(x, q, s, **kw(nw, res)))
        if not err <= sm.TOL["fused_dense_q8"]:
            raise AssertionError(f"K9 {site} M {M}: max_abs_err {err}")
        yield dict(kernel="K9", shape=f"{site} ({mode}) M {M}", max_abs_err=err,
                   sha256=digest(out),
                   **timed(sm, f"K9 {site} M {M}", k9, sets, 20 if M > 8 else 50, unfused))


def k7q_cases(sm, dev):
    """K7q at the 7B FFN, M 1 to 8; the weights' two sets shared by every M."""
    from prego_tpu_torch.ops import fused_ffn as ffn
    from prego_tpu_torch.ops import quant

    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    bf16, eps, D, F = torch.bfloat16, 1e-5, 4096, 11008
    rn = lambda *shape, scale=1.0: torch.randn(*shape, device=dev, generator=gen) * scale
    weights = sm.copies_past_l2(lambda: (
        (rn(D, scale=0.1) + 1).to(bf16),
        *quant.quantize_weight(rn(D, 2 * F, scale=D ** -0.5)),
        *quant.quantize_weight(rn(F, D, scale=F ** -0.5))), 3 * D * F)

    def unfused(h, nw, w13q, w13s, w2q, w2s):
        g13 = quant.int8_matmul(ffn.rms_norm(h, nw, eps), w13q, w13s)
        act = (torch.nn.functional.silu(g13[:, :F]) * g13[:, F:]).to(bf16)
        return h + quant.int8_matmul(act, w2q, w2s).to(bf16)

    def k7q(*a):
        return ffn.fused_ffn_block_q8(*a, eps)
    for M in range(1, 9):
        sets = [(rn(M, D).to(bf16), *w) for w in weights]
        out = k7q(*sets[0])
        err = sm.max_err(out, ffn.fused_ffn_block_q8_reference(*sets[0], eps))
        if CHECK and not err <= sm.TOL["fused_ffn_block_q8"]:
            raise AssertionError(f"K7q M {M}: max_abs_err {err}")
        if CHECK and not torch.equal(k7q(*sets[0]), out):
            raise AssertionError(f"K7q M {M}: a second call gave other bits")
        yield dict(kernel="K7q", shape=f"M {M} D {D} F {F}", max_abs_err=err,
                   sha256=digest(out), **timed(sm, f"K7q M {M}", k7q, sets, 50, unfused))


def k7_cases(sm, dev, block):
    """K7a (block) at the 7B FFN, M 1 and 8, at Mistral-7B's, M 1, 8, 16,
    24 and 32, and at DeepSeek-V2-Lite's dense layer 0, M 8 and 32; or K7 at
    the 1B FFN, M 1 and 8, at the 7B FFN, M 1, and at DeepSeek-V2-Lite's
    shared experts, M 8 and 32. Each beside its bound: the weights (and the
    norm's) read once, the rows in and out, at 3.35 TB/s."""
    from prego_tpu_torch.ops import fused_ffn as ffn

    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    bf16, eps = torch.bfloat16, 1e-5
    rn = lambda *shape, scale=1.0: (torch.randn(*shape, device=dev, generator=gen) * scale).to(bf16)
    name = "K7a" if block else "K7"
    shapes = ([(4096, 11008, (1, 8)), (4096, 14336, (1, 8, 16, 24, 32)), (2048, 10944, (8, 32))]
              if block else [(2048, 5632, (1, 8)), (4096, 11008, (1,)), (2048, 2816, (8, 32))])
    for D, F, rows in shapes:
        weights = sm.copies_past_l2(lambda: (rn(D, scale=0.1) + 1, rn(D, 2 * F, scale=D ** -0.5),
                                             rn(F, D, scale=F ** -0.5)), 6 * D * F)
        for M in rows:
            sets = [(rn(M, D), *w) for w in weights]
            if block:
                fn = lambda h, nw, w13, w2: ffn.fused_ffn_block(h, nw, w13, w2, eps)
                ref = lambda h, nw, w13, w2: ffn.fused_ffn_block_reference(h, nw, w13, w2, eps)
            else:
                fn = lambda h, nw, w13, w2: ffn.fused_ffn(h, w13, w2)
                ref = lambda h, nw, w13, w2: ffn.fused_ffn_reference(h, w13, w2)
            out = fn(*sets[0])
            tol = sm.TOL["fused_ffn_block" if block else "fused_ffn"]
            err = sm.max_err(out, ref(*sets[0]))
            if CHECK and not err <= tol:
                raise AssertionError(f"{name} M {M} D {D}: max_abs_err {err}")
            if CHECK and not torch.equal(fn(*sets[0]), out):
                raise AssertionError(f"{name} M {M} D {D}: a second call gave other bits")
            nbytes = 2 * (3 * D * F + 2 * M * D + D) if block else 2 * 3 * D * F + 6 * M * D
            yield dict(kernel=name, shape=f"M {M} D {D} F {F}", max_abs_err=err,
                       sha256=digest(out), bound_ms=nbytes / 3.35e9,
                       **timed(sm, f"{name} M {M} D {D}", fn, sets, 50))
        del weights


K1_SHAPES = ((64, 256), (16, 128), (128, 512))  # (B, T) at H 1024


def k1_inputs(dev, B, T, H, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = H ** -0.5
    xg = torch.randn(T, B, 3 * H, device=dev, generator=gen).to(torch.bfloat16)
    h0 = torch.randn(B, H, device=dev, generator=gen) * 0.5
    w = ((torch.rand(H, 3 * H, device=dev, generator=gen) * 2 - 1) * k).to(torch.bfloat16)
    b = (torch.rand(3 * H, device=dev, generator=gen) * 2 - 1) * k
    return xg, h0, w, b


def k1_cases(sm, dev):
    """K1 at H 1024 and K1_SHAPES; one input set (W_hh is read once a call
    and stays resident, so L2 does not flatter the rest)."""
    from prego_tpu_torch.ops import gru_cuda

    H = 1024
    for B, T in K1_SHAPES:
        sets = [k1_inputs(dev, B, T, H, seed=B + T)]
        hs, hT = gru_cuda.gru_recurrence(*sets[0])
        ref_hs, ref_hT = gru_cuda.gru_recurrence_reference(*sets[0])
        err = max(sm.max_err(hs, ref_hs), sm.max_err(hT, ref_hT))
        if CHECK and not err <= sm.TOL["gru_recurrence"]:
            raise AssertionError(f"K1 B {B} T {T}: max_abs_err {err}")
        again = gru_cuda.gru_recurrence(*sets[0])
        if CHECK and not (torch.equal(again[0], hs) and torch.equal(again[1], hT)):
            raise AssertionError(f"K1 B {B} T {T}: a second call gave other bits")
        case = dict(kernel="K1", shape=f"B {B} T {T} H {H}", max_abs_err=err,
                    sha256=digest(hs, hT), **timed(sm, f"K1 B {B} T {T}", gru_cuda.gru_recurrence,
                                                   sets, 10))
        if case["device_ms"] is not None:
            case["device_us_per_frame"] = case["device_ms"] / T * 1e3
        case["us_per_frame"] = case["ms"] / T * 1e3
        yield case


def k1_split_cases(sm, dev):
    """K1's design of dc1e0f6 with phase stamps, and T empty exchanges over
    its 128 CTAs (tools/gru_split.cu)."""
    from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, stream_ptr

    kernel = CudaKernel("gru_split", str(REPO / "tools" / "gru_split.cu"),
                        {"prego_gru_split": [c_ptr] * 8 + [c_int] * 3 + [c_ptr],
                         "prego_gru_empty_round": [c_ptr] + [c_int] * 3 + [c_ptr]})
    H = 1024
    grid = H // 8
    phases = ("copy_h", "product", "gate_math", "grid_barrier")
    for B, T in K1_SHAPES:
        xg, h0, w, b = k1_inputs(dev, B, T, H, seed=B + T)
        hs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
        hT = torch.empty(B, H, device=dev)
        hbuf = torch.empty(2, B, H, dtype=torch.bfloat16, device=dev)
        stamps = torch.zeros(grid, 4, dtype=torch.int64, device=dev)

        def split():
            kernel.call("prego_gru_split", xg.data_ptr(), h0.data_ptr(), w.data_ptr(),
                        b.data_ptr(), hs.data_ptr(), hT.data_ptr(), hbuf.data_ptr(),
                        stamps.data_ptr(), T, B, H, stream_ptr(dev))
        ms = sm.time_ms(split, 5)
        cycles = stamps.double().mean(0) / T  # a frame's cycles in each phase, mean over CTAs
        frame_us = ms / T * 1e3
        share = cycles / cycles.sum()
        counter = torch.zeros(2, dtype=torch.int32, device=dev)
        rounds = {}
        for mode, name in ((0, "grid_sync"), (1, "arrive_wait")):
            def empty():
                kernel.call("prego_gru_empty_round", counter.data_ptr(), T, grid, mode,
                            stream_ptr(dev))
            rounds[f"{name}_us_per_round"] = sm.time_ms(empty, 5) / T * 1e3
        if int(counter.abs().sum()) != 0:
            raise AssertionError("the empty rounds left their counter nonzero")
        yield dict(kernel="K1 split (dc1e0f6's design)", shape=f"B {B} T {T} H {H}",
                   us_per_frame=frame_us,
                   cycles_per_frame={p: float(c) for p, c in zip(phases, cycles)},
                   us_per_frame_by_phase={p: float(s) * frame_us for p, s in zip(phases, share)},
                   **rounds)


K6_SHAPES = ((16, 128), (64, 128))  # (B, T) at H 1024
K6_PHASES = ("stage_h_prev", "gate_product", "gate_math", "grid_barrier", "stage_dhg",
             "dh_product")


def k6_inputs(dev, B, T, H, seed):
    """xg, h_prev, dhs and W_hh bf16 as the trainable layer streams them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    k = H ** -0.5
    bf16 = torch.bfloat16
    return (torch.randn(T, B, 3 * H, device=dev, generator=gen).to(bf16),
            (torch.rand(T, B, H, device=dev, generator=gen) * 1.8 - 0.9).to(bf16),
            (torch.randn(T, B, H, device=dev, generator=gen) * 0.5).to(bf16),
            ((torch.rand(H, 3 * H, device=dev, generator=gen) * 2 - 1) * k).to(bf16),
            (torch.rand(3 * H, device=dev, generator=gen) * 2 - 1) * k)


def k6_cases(sm, dev):
    """K6 at H 1024 and K6_SHAPES; one input set (W_hh stays resident, as
    in K1's cases). Held to r within GRU_BWD_R_TOL, dxg and dh0 within
    2^-6 of their largest value."""
    from prego_tpu_torch.ops import gru_cuda_vjp

    H = 1024
    for B, T in K6_SHAPES:
        sets = [k6_inputs(dev, B, T, H, seed=B + T)]
        out = gru_cuda_vjp.gru_bwd(*sets[0])
        ref = gru_cuda_vjp.gru_bwd_reference(*sets[0])
        r_err = sm.max_err(out[1], ref[1])
        rel = max(sm.rel_err(out[0], ref[0]), sm.rel_err(out[2], ref[2]))
        if CHECK and not (r_err <= sm.GRU_BWD_R_TOL and rel <= sm.TOL["gru_bwd"]):
            raise AssertionError(f"K6 B {B} T {T}: r error {r_err}, relative error {rel}")
        again = gru_cuda_vjp.gru_bwd(*sets[0])
        if CHECK and not all(torch.equal(a, b) for a, b in zip(again, out)):
            raise AssertionError(f"K6 B {B} T {T}: a second call gave other bits")
        case = dict(kernel="K6", shape=f"B {B} T {T} H {H}", r_max_abs_err=r_err,
                    max_rel_err=rel, max_abs_err=max(sm.max_err(a, b) for a, b in zip(out, ref)),
                    sha256=digest(*out),
                    **timed(sm, f"K6 B {B} T {T}", gru_cuda_vjp.gru_bwd, sets, 10))
        if case["device_ms"] is not None:
            case["device_us_per_frame"] = case["device_ms"] / T * 1e3
        case["us_per_frame"] = case["ms"] / T * 1e3
        yield case


def k6_split_cases(sm, dev):
    """K6's design of 09bfd55 with phase stamps (tools/gru_bwd_split.cu)."""
    from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, stream_ptr

    kernel = CudaKernel("gru_bwd_split", str(REPO / "tools" / "gru_bwd_split.cu"),
                        {"prego_gru_bwd_split": [c_ptr] * 10 + [c_int] * 3 + [c_ptr]})
    H = 1024
    grid = H // 8
    for B, T in K6_SHAPES:
        xg, hp, dhs, w, b = k6_inputs(dev, B, T, H, seed=B + T)
        dxg = torch.empty(T, B, 3 * H, dtype=torch.bfloat16, device=dev)
        r = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
        dh0 = torch.empty(B, H, device=dev)
        gbuf = torch.empty(2, B, 3 * H, dtype=torch.bfloat16, device=dev)
        stamps = torch.zeros(grid, len(K6_PHASES), dtype=torch.int64, device=dev)

        def split():
            kernel.call("prego_gru_bwd_split", xg.data_ptr(), hp.data_ptr(), dhs.data_ptr(),
                        w.data_ptr(), b.data_ptr(), dxg.data_ptr(), r.data_ptr(), dh0.data_ptr(),
                        gbuf.data_ptr(), stamps.data_ptr(), T, B, H, stream_ptr(dev))
        ms = sm.time_ms(split, 5)
        cycles = stamps.double().mean(0) / T  # a frame's cycles in each phase, mean over CTAs
        frame_us = ms / T * 1e3
        share = cycles / cycles.sum()
        yield dict(kernel="K6 split (09bfd55's design)", shape=f"B {B} T {T} H {H}",
                   us_per_frame=frame_us,
                   cycles_per_frame={p: float(c) for p, c in zip(K6_PHASES, cycles)},
                   us_per_frame_by_phase={p: float(s) * frame_us for p, s in zip(K6_PHASES, share)})


def tile_rows_cases(sm, dev):
    """K4's tile kernel with tiles of 128 (2 warpgroups) and 256 rows (4)
    where w8::launch_tile takes 128."""
    from prego_tpu_torch.ops import quant
    from prego_tpu_torch.ops._cuda import CudaKernel, c_int, c_ptr, stream_ptr

    kernel = CudaKernel("w8_tile_rows", str(REPO / "tools" / "w8_tile_rows.cu"),
                        {"prego_w8_tile_rows": [c_ptr] * 4 + [c_int] * 4 + [c_ptr]})

    def tiles(wg):
        def run(x, q, s):
            M, K = x.shape
            N = q.shape[1]
            out = torch.empty(M, N, dtype=torch.float32, device=x.device)
            kernel.call("prego_w8_tile_rows", x.data_ptr(), q.data_ptr(), s.data_ptr(),
                        out.data_ptr(), M, K, N, wg, stream_ptr(x.device))
            return out
        return run

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for M, name in ((128, "wo"), (256, "wqkv"), (512, "wo"), (1024, "w2")):
        K, N = sm.PROJ_7B[name]
        sets = sm.copies_past_l2(k4_inputs(gen, dev, M, K, N), K * N)
        ref = quant.int8_matmul_reference(*sets[0])
        case = dict(kernel="K4 tile rows", shape=f"{name} M {M}")
        for wg in (2, 4):
            err = sm.max_err(tiles(wg)(*sets[0]), ref)
            if not err <= sm.TOL["int8_matmul"]:
                raise AssertionError(f"K4 tiles of {64 * wg} rows at {name} M {M}: {err}")
            case[f"rows_{64 * wg}"] = dict(
                max_abs_err=err, ms=sm.time_ms_cycle(tiles(wg), sets, 20),
                device_ms=sm.device_ms_cycle(tiles(wg), sets, what=f"{64 * wg} rows"))
        yield case


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True, help="checkout whose port is timed")
    ap.add_argument("--kernels", default="K2,K4,K5,K3,K8,K8u,K9,K7q,K7a,K7,K1,K6",
                    help="which kernels' cases, in order")
    ap.add_argument("--tile-rows", action="store_true",
                    help="also time K4's tiles of 128 and 256 rows (this checkout only)")
    ap.add_argument("--k5-cluster", action="store_true",
                    help="also time K5's GEMV with a cluster reduce (this checkout only)")
    ap.add_argument("--k1-split", action="store_true",
                    help="also split a frame of dc1e0f6's K1 by phase, and time empty exchanges")
    ap.add_argument("--k6-split", action="store_true",
                    help="also split a frame of 09bfd55's K6 by phase")
    ap.add_argument("--no-check", action="store_true",
                    help="time K7q's, K7's, K1's and K6's cases without holding them to their "
                         "plain versions")
    args = ap.parse_args()
    global CHECK
    CHECK = not args.no_check
    root = args.root.resolve()
    if (args.tile_rows or args.k5_cluster) and root != REPO:
        ap.error("--tile-rows and --k5-cluster time this checkout's kernels: --root must be it")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import prego_tpu_torch

    if Path(prego_tpu_torch.__file__).resolve().parents[1] != root:
        raise AssertionError(f"prego_tpu_torch came from {prego_tpu_torch.__file__}, not {root}")
    sm = load_smoke()
    sm.build_kernels()  # one nvcc per source, all at once
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = sm.nvidia_smi_line()
    runs = {"K2": lambda: k2_cases(sm, dev), "K4": lambda: k4_cases(sm, dev),
            "K5": lambda: k5_cases(sm, dev, args.k5_cluster),
            "K3": lambda: k3_cases(sm, dev), "K8": lambda: k8_cases(sm, dev, upd=False),
            "K8u": lambda: k8_cases(sm, dev, upd=True), "K9": lambda: k9_cases(sm, dev),
            "K7q": lambda: k7q_cases(sm, dev), "K7a": lambda: k7_cases(sm, dev, block=True),
            "K7": lambda: k7_cases(sm, dev, block=False), "K1": lambda: k1_cases(sm, dev),
            "K6": lambda: k6_cases(sm, dev)}
    names = args.kernels.split(",")
    if args.tile_rows:
        runs["K4 tile rows"] = lambda: tile_rows_cases(sm, dev)
        names.append("K4 tile rows")
    if args.k1_split:
        runs["K1 split"] = lambda: k1_split_cases(sm, dev)
        names.append("K1 split")
    if args.k6_split:
        runs["K6 split"] = lambda: k6_split_cases(sm, dev)
        names.append("K6 split")
    for name in names:
        for case in runs[name]():
            print(json.dumps(dict(root=str(args.root), card=card, **case)), flush=True)
    print(json.dumps(dict(root=str(args.root), device_ms_sessions=sm.device_ms_report())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
