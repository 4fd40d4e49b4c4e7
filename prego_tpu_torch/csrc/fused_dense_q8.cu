// K9: the int8-weight projection with an rms_norm prologue or a residual
// epilogue, on Hopper.
//
// Replaces prego_tpu/ops/fused_dense.py::fused_dense_q8 (Pallas bodies
// _norm_kernel and _res_kernel). For x (M, K) bf16, q (K, N) int8 and one
// f32 scale per column s (N,):
//   norm mode      out = cast(rms_norm(x, norm_w) . q * s)   bf16 or f32 out
//   residual mode  out = residual + bf16(x . q * s)          bf16 out
// with rms_norm's dtype walk (rms_norm.cuh) and K4's product (bf16 x int8
// products exact in f32, f32 sums, the scale after the sum).
//
// What bounds it here: at decode (M = batch <= 8) every weight byte is used
// M times, so the call streams the int8 weights once: K N bytes (the 7B
// qkv 50.3 MB, wo 16.8 MB, lm-head 131 MB; 15.0, 5.0 and 39.1 us at 3.35
// TB/s). The TPU kernel keeps the normed rows resident in VMEM across a
// sequential grid over N tiles; here the blocks run in parallel, so
// the design is K4's, and so is its choice of path by M. Above 8 rows (a
// prefill of up to 64 rows reaches the lm-head's K9) the products bound
// it, on the tensor cores.
//
// Design: one C entry point issues all launches (one host call a
// projection). Norm mode first writes xn (M, K) bf16, one block per row
// (rms_norm.cuh; M x K x 2 bytes, read back from L2). Then K4's products
// (w8_matmul.cuh): at M <= 8 the streaming GEMV, 128 columns a block, K
// split so that ~4 blocks run per SM, f32 partial sums per split; above,
// the mma.sync tiles, scaled y in f32. The last launch sums the splits in
// order and folds the rest of the op sequence in: the column scale, the
// cast to the output type or the residual add in bf16 (an f32 tile output
// needs none). No atomics: the same bits every run.
#include <stdint.h>

#include "common.cuh"
#include "rms_norm.cuh"
#include "w8_matmul.cuh"

namespace {

constexpr int kThreads = 256;

// y = sum over splits, in order, times s (none from the tile path: its y
// is scaled); then (kResidual) bf16(res + bf16(y)), or y cast to the
// output type
template <bool kResidual, typename Out>
__global__ void __launch_bounds__(kThreads) dense_q8_reduce_kernel(
    const float* __restrict__ part,               // (S, M, N)
    const float* __restrict__ scale,              // (N,)
    const __nv_bfloat16* __restrict__ residual,   // (M, N), kResidual only
    Out* __restrict__ out, int MN, int N, int S) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= MN) return;
    float y = 0.f;
    for (int s = 0; s < S; ++s) y += part[static_cast<size_t>(s) * MN + i];
    if (scale != nullptr) y *= scale[i % N];
    if constexpr (kResidual)
        out[i] = f2bf(bf2f(residual[i]) + round_bf16(y));
    else if constexpr (sizeof(Out) == 2)
        out[i] = f2bf(y);
    else
        out[i] = y;
}

template <bool kResidual, typename Out>
cudaError_t reduce(const void* part, const void* s, const void* residual, void* out, int MN,
                   int N, int S, cudaStream_t st) {
    dense_q8_reduce_kernel<kResidual, Out><<<(MN + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(s),
        static_cast<const __nv_bfloat16*>(residual), static_cast<Out*>(out), MN, N, S);
    return cudaGetLastError();
}

}  // namespace

// Splits of K of the streaming path (M <= 8), for the wrapper's scratch;
// 0 selects the tile path (M > 8), whose scratch is one (M, N) f32 unless
// the output is f32 (norm mode).
PREGO_EXPORT int prego_fused_dense_q8_splits(int M, int K, int N) {
    return M > w8::kMaxM ? 0 : w8::num_splits(K, N);
}

// K9: out (M, N) from x (M, K) bf16, q (K, N) int8, s (N,) f32, with either
// norm_w (K,) bf16 (norm mode: xn (M, K) bf16 scratch, out bf16 if out_bf16
// else f32) or residual (M, N) bf16 (residual mode: xn unused, out bf16).
// part is f32 scratch (max(splits, 1), M, N), splits =
// prego_fused_dense_q8_splits (unused by the tile path with an f32 out).
// M >= 1; K and N multiples of 8.
PREGO_EXPORT int prego_fused_dense_q8(const void* x, const void* norm_w, const void* residual,
                                      const void* q, const void* s, void* xn, void* part,
                                      void* out, int M, int K, int N, int splits, int out_bf16,
                                      float eps, void* stream) {
    const bool norm = norm_w != nullptr;
    if (M < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0 ||
        splits != prego_fused_dense_q8_splits(M, K, N) || norm == (residual != nullptr) ||
        (norm && xn == nullptr) || (!norm && !out_bf16))
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (norm) {
        err = rms_norm::launch<false>(x, norm_w, xn, M, K, eps, st);
        if (err != cudaSuccess) return err;
    }
    const void* a = norm ? xn : x;
    if (splits == 0) {  // the tile path: y scaled in f32, into out when that is f32
        const bool direct = norm && !out_bf16;
        err = w8::launch_tile(a, q, s, direct ? out : part, M, K, N, st);
        if (err != cudaSuccess || direct) return err;
        s = nullptr;  // applied
        splits = 1;
    } else {
        err = w8::launch_gemv(a, q, part, M, K, N, splits, st);
        if (err != cudaSuccess) return err;
    }
    if (!norm) return reduce<true, __nv_bfloat16>(part, s, residual, out, M * N, N, splits, st);
    if (out_bf16) return reduce<false, __nv_bfloat16>(part, s, nullptr, out, M * N, N, splits, st);
    return reduce<false, float>(part, s, nullptr, out, M * N, N, splits, st);
}
