// rms_norm of M bf16 rows, the first launch of K7a / K7q (fused_ffn.cu)
// and of K9's norm mode (fused_dense_q8.cu).
//
// The JAX dtype walk (prego_tpu/models/llama/model.py::rms_norm): f32
// mean square and rsqrt, the normed value cast to bf16, then the bf16
// product with the weight. One block per row.
#pragma once

#include "common.cuh"

namespace rms_norm {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// kTransposed: xn is stored (D, M), so that one vector load gives a weight
// row's M activations (K7a, K7q); else (M, D) (K9). D a multiple of 8.
template <bool kTransposed>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(
    const __nv_bfloat16* __restrict__ h,       // (M, D)
    const __nv_bfloat16* __restrict__ norm_w,  // (D,)
    __nv_bfloat16* __restrict__ xn,            // (D, M) or (M, D)
    int M, int D, float eps) {
    __shared__ float warp_part[kWarps];
    __shared__ float inv_rms;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, m = blockIdx.x;
    const __nv_bfloat16* row = h + static_cast<size_t>(m) * D;
    float ss = 0.f;
    for (int i = tid; i < D / 8; i += kThreads) {  // 8 values a load
        const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
        const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float2 v = bf16x2_to_float2(w[k]);
            ss = fmaf(v.y, v.y, fmaf(v.x, v.x, ss));
        }
    }
    ss = warp_sum(ss);
    if (lane == 0) warp_part[warp] = ss;
    __syncthreads();
    if (tid == 0) {
        float tot = 0.f;
        for (int w = 0; w < kWarps; ++w) tot += warp_part[w];
        inv_rms = 1.f / sqrtf(tot / static_cast<float>(D) + eps);
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
        const float normed = round_bf16(bf2f(row[d]) * inv_rms);
        const size_t at = kTransposed ? static_cast<size_t>(d) * M + m
                                      : static_cast<size_t>(m) * D + d;
        xn[at] = f2bf(normed * bf2f(norm_w[d]));
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
