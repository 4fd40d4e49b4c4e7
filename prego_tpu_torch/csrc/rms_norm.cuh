// rms_norm of M bf16 rows, the first launch of K7a / K7q (fused_ffn.cu)
// and of K9's norm mode (fused_dense_q8.cu) unless K9's GEMV folds the
// statistic and the rounding below into its prologue.
//
// The JAX dtype walk (prego_tpu/models/llama/model.py::rms_norm): f32
// mean square and rsqrt, the normed value cast to bf16, then the bf16
// product with the weight. One block per row. Each block first lets the
// launch that depends on it start (hopper::launch_dependents): K9's GEMV,
// launched as its programmatic dependent, prefetches its weights meanwhile.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace rms_norm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 1 / rms of the M rows of h (M, D) bf16 into inv_rms[m] (shared memory),
// by a block of kThreads threads: each thread sums the squares of its
// 8-value loads of a row in order (f32), the warps' sums are added in warp
// order, then 1 / sqrt(mean + eps). The norm launch below, K9's GEMV
// prologue (fused_dense_q8.cu) and K7q's and K7a's ring prologues all take
// their statistic from here, so they agree bit for bit. kMasked: only the
// first `rows` of the M rows exist (a row's sum is the same either way).
// D a multiple of 8, rows 16-byte aligned. Ends with a barrier.
template <int M, bool kMasked = false>
__device__ __forceinline__ void inv_rms_rows(const __nv_bfloat16* __restrict__ h, int D,
                                             float eps, float (*warp_part)[kWarps],
                                             float* inv_rms, int rows = M) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float ss[M];
#pragma unroll
    for (int m = 0; m < M; ++m) ss[m] = 0.f;
    for (int i = tid; i < D / 8; i += kThreads) {  // 8 values a load, every row's at once
        uint4 raw[M];
#pragma unroll
        for (int m = 0; m < M; ++m)
            raw[m] = !kMasked || m < rows
                         ? reinterpret_cast<const uint4*>(h + static_cast<size_t>(m) * D)[i]
                         : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const unsigned int w[4] = {raw[m].x, raw[m].y, raw[m].z, raw[m].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float2 v = bf16x2_to_float2(w[k]);
                ss[m] = fmaf(v.y, v.y, fmaf(v.x, v.x, ss[m]));
            }
        }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const float s = warp_sum(ss[m]);
        if (lane == 0 && (!kMasked || m < rows)) warp_part[m][warp] = s;
    }
    __syncthreads();
    if (tid < (kMasked ? rows : M)) {
        float tot = 0.f;
        for (int w = 0; w < kWarps; ++w) tot += warp_part[tid][w];
        inv_rms[tid] = 1.f / sqrtf(tot / static_cast<float>(D) + eps);
    }
    __syncthreads();
}

// The normed value of h's row m, column d, as the norm launch writes it:
// bf16(bf16(h * inv_rms) * norm_w), in f32
__device__ __forceinline__ float normed(const __nv_bfloat16* h, const __nv_bfloat16* norm_w,
                                        float inv_rms, int m, int d, int D) {
    const float v = round_bf16(bf2f(h[static_cast<size_t>(m) * D + d]) * inv_rms);
    return round_bf16(v * bf2f(norm_w[d]));
}

// kTransposed: xn is stored (D, M), so that one vector load gives a weight
// row's M activations (K7a, K7q); else (M, D) (K9). D a multiple of 8.
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(
    const __nv_bfloat16* __restrict__ h,       // (M, D)
    const __nv_bfloat16* __restrict__ norm_w,  // (D,)
    __nv_bfloat16* __restrict__ xn,            // (D, M) or (M, D)
    int M, int D, float eps) {
    hopper::launch_dependents();
    __shared__ float warp_part[1][kWarps];
    __shared__ float inv_rms[1];
    const int tid = threadIdx.x, m = blockIdx.x;
    inv_rms_rows<1>(h + static_cast<size_t>(m) * D, D, eps, warp_part, inv_rms);
    for (int d = tid; d < D; d += kThreads) {
        const size_t at = kTransposed ? static_cast<size_t>(d) * M + m
                                      : static_cast<size_t>(m) * D + d;
        xn[at] = f2bf(normed(h, norm_w, inv_rms[0], m, d, D));
    }
}

// xn from h, one block per row, on ``stream``
template <bool kTransposed>
cudaError_t launch(const void* h, const void* norm_w, void* xn, int M, int D, float eps,
                   cudaStream_t stream) {
    rms_norm_kernel<kTransposed><<<M, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(norm_w),
        static_cast<__nv_bfloat16*>(xn), M, D, eps);
    return cudaGetLastError();
}

}  // namespace rms_norm
