// K3: bounded single-token GQA decode attention over an int8 KV cache.
//
// Replaces prego_tpu/ops/decode_attention.py::decode_attention_bounded_q8
// in its default mode (int8_mxu=False) and its Pallas bodies
// (_decode_kernel_bounded_q8, _q8_fold, _q8_fold_flat with the q8 branch
// of _flat_group_update, all through _q8_head_update's arithmetic). Those
// are TPU schedules of one function. The cache holds int8 K and V with one
// f32 scale per (row, head, position), ks/vs (B, KV, T). For each row b
// and kv head g, the R query rows of q[b, g] attend over t < valid[b]:
//   s_t  = (bf16(q) . k_t) * ks_t / sqrt(hd)     products exact in f32
//   p_t  = exp(s_t - m), 0 where masked;  l = sum of the f32 p_t
//   pv_t = bf16(p_t * vs_t)                      rounded before the product
//   out  = (sum_t pv_t v_t) / max(l, 1e-30)      in q's dtype (bf16)
// valid == 0 gives zeros.
//
// K3m, the int8_mxu=True mode (_q8_head_update's int8 branches; no model
// path selects it, as in the JAX package): q is quantized per (row, head)
// over hd, qs = max(|q|, 1e-8) / 127, q8 = rint(q / qs), and
//   s_t  = f32(int32 q8 . k_t) * qs * ks_t / sqrt(hd)
// then, per query row of a 64-position split (the JAX kernel: of its
// 256-position block), pv = p * vs is quantized against the split's
// largest value, ps = max(|pv|, 1e-30) / (127 * 128), pq = rint(pv / ps),
// and split into 7-bit parts hi = floor(pq / 128), lo = pq - 128 hi, so
//   acc  = (f32(int32 hi . v) * 128 + f32(int32 lo . v)) * ps
// Every int8 product and int32 sum is exact (__dp4a), so the kernel and
// its plain version differ only where an f32 rounding (exp, the scales)
// moves a pq across a rounding boundary.
//
// What bounds it here: one decode step reads the int8 K and V below the
// bounds once plus their scales (2 x B x KV x valid x (hd + 4) bytes, about
// half of K2's bf16 traffic) with 4 FLOPs per cache element: memory bound,
// like K2, and at the decode shapes latency bound, since few blocks run.
//
// Design: split-K flash decoding, as K8's (csrc/decode_split.cuh). Pass 1
// runs one block per (split of 64 positions, g, b) and returns at once
// past valid[b], which stays on the device. Scores: two threads per
// position, each reading alternate 16-byte runs of the key row (16 int8
// values a load), converted exactly to f32 (common.cuh). Values: a lane
// reads 16 channels of a value row in one 16-byte load; 4 lane groups of a
// warp take every fourth of its 16 positions and are summed with shuffles,
// the 4 warps in warp order through shared memory. pv is rounded to bf16
// against the split's own max, not the row's (the plain version uses the
// row's): each pv moves by at most 2^-9 of itself between the two. Pass 2
// merges the live splits with the log-sum-exp rule, as in K8. No atomics.
// The wrapper keeps the scratch as a persistent workspace, so a call
// allocates only its output. One-launch designs (the splits merged by the
// last to arrive through a ticket in the same launch, 64 to 512 positions
// a block, loads by register, cp.async or bulk copy) took 1.18-1.6x this
// design's device time at the 7B shape with ragged bounds, and were not
// kept (PERF.md, section 6, K3's one-launch designs).
// K3m (template flag kMxu) keeps the layout: q8 . k with __dp4a on the
// 16-byte key runs; for PV, a lane reads 4 consecutive value rows of its
// 16 channels, transposes the 4 x 4 byte blocks with byte permutes so that
// one word holds 4 positions of a channel, and dots them with 4 packed hi
// (then lo) codes; the int32 sums of the warps meet in shared memory.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;   // cache positions per pass-1 block
constexpr int kMaxR = 8;     // query rows per kv head
constexpr int kMaxHd = 256;  // head dim

template <int R, bool kMxu>
__global__ void __launch_bounds__(kThreads) decode_q8_split_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, KV, R, hd)
    const int8_t* __restrict__ kq,        // (B, KV, T, hd)
    const float* __restrict__ ks,         // (B, KV, T)
    const int8_t* __restrict__ vq,        // (B, KV, T, hd)
    const float* __restrict__ vs,         // (B, KV, T)
    const int* __restrict__ valid,        // (B,)
    float* __restrict__ part_acc,         // (B, KV, NS, R, hd)
    float* __restrict__ part_ml,          // (B, KV, NS, R, 2)
    int KV, int T, int hd, int NS, float scale) {
    const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int vl = min(valid[b], T);
    const int t0 = s * kSplit;
    if (t0 >= vl) return;  // never read: pass 2 only merges splits below vl
    const int n = min(kSplit, vl - t0);

    __shared__ float q_s[R][kMaxHd];
    __shared__ float p_s[R][kSplit];
    __shared__ float ks_s[kSplit], vs_s[kSplit];
    __shared__ __align__(16) float red[kWarps][R][kMaxHd];  // PV partial sums per warp
    // K3m only: q8 and its scales; the hi and lo codes of pv and their scales
    constexpr int kQ = kMxu ? R : 1;
    __shared__ __align__(16) int8_t q8_s[kQ][kMxu ? kMaxHd : 16];
    __shared__ __align__(16) int8_t pq_s[2][kQ][kMxu ? kSplit : 16];
    __shared__ float qs_s[kQ], ps_s[kQ];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t bg = static_cast<size_t>(b) * KV + g;

    for (int idx = tid; idx < R * hd; idx += kThreads)
        q_s[idx / hd][idx % hd] = bf2f(q[bg * R * hd + idx]);
    if (tid < n) ks_s[tid] = ks[bg * T + t0 + tid];
    if (tid >= kSplit && tid - kSplit < n) vs_s[tid - kSplit] = vs[bg * T + t0 + tid - kSplit];
    __syncthreads();
    if constexpr (kMxu) {  // q quantized per row, one warp a row
        for (int r = warp; r < R; r += kWarps) {
            float qmax = 0.f;
            for (int d = lane; d < hd; d += 32) qmax = fmaxf(qmax, fabsf(q_s[r][d]));
            const float qs = fmaxf(warp_max(qmax), 1e-8f) / 127.f;
            for (int d = lane; d < hd; d += 32)
                q8_s[r][d] = static_cast<int8_t>(rintf(q_s[r][d] / qs));
            if (lane == 0) qs_s[r] = qs;
        }
        __syncthreads();
    }

    // scores: two threads per position, alternate 16-byte runs of the key
    // row, joined with one shuffle; the scales after the dot
    {
        const int j = tid >> 1, half = tid & 1;
        float part[R];
        int part_i[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            part[r] = 0.f;
            part_i[r] = 0;
        }
        if (j < n) {
            const int8_t* krow = kq + (bg * T + t0 + j) * hd;
#pragma unroll 2
            for (int d = half * 16; d < hd; d += 32) {
                const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
                const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if constexpr (kMxu) {
#pragma unroll
                        for (int r = 0; r < R; ++r)
                            part_i[r] = __dp4a(static_cast<int>(w[i]),
                                               *reinterpret_cast<const int*>(&q8_s[r][d + 4 * i]),
                                               part_i[r]);
                    } else {
                        float kf[4];
                        int8x4_to_float(w[i], kf);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
#pragma unroll
                            for (int r = 0; r < R; ++r)
                                part[r] = fmaf(q_s[r][d + 4 * i + e], kf[e], part[r]);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            if constexpr (kMxu) {
                part_i[r] += __shfl_xor_sync(0xffffffffu, part_i[r], 1);
                if (j < n && half == 0)
                    p_s[r][j] = static_cast<float>(part_i[r]) * qs_s[r] * ks_s[j] * scale;
            } else {
                part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
                if (j < n && half == 0) p_s[r][j] = part[r] * ks_s[j] * scale;
            }
        }
    }
    __syncthreads();

    // split-local softmax statistics, one warp per query row; p is kept in
    // f32 for l, and p * vs rounded to bf16 for the value product (K3), or
    // quantized into its hi and lo codes (K3m)
    float* ml = part_ml + ((bg * NS + s) * R) * 2;
    for (int r = warp; r < R; r += kWarps) {
        const float a = lane < n ? p_s[r][lane] : -INFINITY;
        const float c = lane + 32 < n ? p_s[r][lane + 32] : -INFINITY;
        const float m = warp_max(fmaxf(a, c));
        const float pa = lane < n ? expf(a - m) : 0.f;
        const float pc = lane + 32 < n ? expf(c - m) : 0.f;
        if constexpr (kMxu) {
            const float va = lane < n ? pa * vs_s[lane] : 0.f;
            const float vc = lane + 32 < n ? pc * vs_s[lane + 32] : 0.f;
            const float ps = fmaxf(warp_max(fmaxf(fabsf(va), fabsf(vc))), 1e-30f) / 16256.f;
            const float qa = rintf(va / ps), qc = rintf(vc / ps);
            const float ha = floorf(qa / 128.f), hc = floorf(qc / 128.f);
            pq_s[0][r][lane] = static_cast<int8_t>(ha);
            pq_s[0][r][lane + 32] = static_cast<int8_t>(hc);
            pq_s[1][r][lane] = static_cast<int8_t>(qa - ha * 128.f);
            pq_s[1][r][lane + 32] = static_cast<int8_t>(qc - hc * 128.f);
            if (lane == 0) ps_s[r] = ps;
        } else {
            p_s[r][lane] = lane < n ? round_bf16(pa * vs_s[lane]) : 0.f;
            p_s[r][lane + 32] = lane + 32 < n ? round_bf16(pc * vs_s[lane + 32]) : 0.f;
        }
        const float l = warp_sum(pa + pc);
        if (lane == 0) {
            ml[r * 2] = m;
            ml[r * 2 + 1] = l;
        }
    }
    __syncthreads();

    const int8_t* vb = vq + (bg * T + t0) * hd;
    const int cq = lane & 7, pg = lane >> 3;
    float* acc_out = part_acc + ((bg * NS + s) * R) * hd;
    if constexpr (kMxu) {
        // int32 PV for the hi codes, then the lo codes: warp w takes
        // positions [16w, 16w + 16), lane = 8 * pg + cq the 4 positions
        // 16w + 4pg .. + 3 of channels [16 cq, 16 cq + 16) (+128)
        int* red_i = reinterpret_cast<int*>(&red[0][0][0]);
        const int jb = warp * (kSplit / kWarps) + 4 * pg;
        for (int half = 0; half < 2; ++half) {
            for (int c0 = 0; c0 < hd; c0 += 128) {
                const int c = c0 + cq * 16;
                int acc[R][16];
#pragma unroll
                for (int r = 0; r < R; ++r)
#pragma unroll
                    for (int i = 0; i < 16; ++i) acc[r][i] = 0;
                if (c < hd && jb < n) {
                    unsigned int rows[4][4];  // 4 positions x 16 channels
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // past n: zero rows
                        if (jb + k < n)
                            raw = *reinterpret_cast<const uint4*>(
                                vb + static_cast<size_t>(jb + k) * hd + c);
                        rows[k][0] = raw.x;
                        rows[k][1] = raw.y;
                        rows[k][2] = raw.z;
                        rows[k][3] = raw.w;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        unsigned int col[4];  // col[e]: 4 positions of channel c + 4i + e
                        transpose4x4(rows[0][i], rows[1][i], rows[2][i], rows[3][i], col);
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const int pw = *reinterpret_cast<const int*>(&pq_s[half][r][jb]);
#pragma unroll
                            for (int e = 0; e < 4; ++e)
                                acc[r][4 * i + e] = __dp4a(static_cast<int>(col[e]), pw,
                                                           acc[r][4 * i + e]);
                        }
                    }
                }
#pragma unroll
                for (int r = 0; r < R; ++r)
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 8);
                        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 16);
                    }
                if (pg == 0 && c < hd) {
#pragma unroll
                    for (int r = 0; r < R; ++r)
#pragma unroll
                        for (int i = 0; i < 16; ++i)
                            red_i[(warp * R + r) * kMaxHd + c + i] = acc[r][i];
                }
            }
            __syncthreads();
            // (hi . v) * 128, then + lo . v and times ps, as the JAX kernel
            // orders it; the same thread owns an index in both halves
            for (int idx = tid; idx < R * hd; idx += kThreads) {
                const int r = idx / hd, d = idx % hd;
                int o = 0;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) o += red_i[(w * R + r) * kMaxHd + d];
                acc_out[idx] = half == 0 ? static_cast<float>(o) * 128.f
                                         : (acc_out[idx] + static_cast<float>(o)) * ps_s[r];
            }
            __syncthreads();  // red is reused by the lo half
        }
        return;
    }

    // acc[r][c] = sum_t pv[r][t] v[t][c]: warp w takes positions
    // [16w, 16w + 16); lane = 8 * pg + cq reads channels [16 cq, 16 cq + 16)
    // (+128, for hd above 128) of positions 16w + pg, + 4, + 8, + 12. Every
    // lane runs every round, so the shuffles see the whole warp.
    const int j0 = warp * (kSplit / kWarps), j1 = min(n, j0 + kSplit / kWarps);
    for (int c0 = 0; c0 < hd; c0 += 128) {
        const int c = c0 + cq * 16;
        float acc[R][16];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[r][i] = 0.f;
        if (c < hd) {
            for (int j = j0 + pg; j < j1; j += 4) {
                const uint4 raw = *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(j) * hd + c);
                const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
                float vf[16];
#pragma unroll
                for (int i = 0; i < 4; ++i) int8x4_to_float(w[i], vf + 4 * i);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float pv = p_s[r][j];
#pragma unroll
                    for (int i = 0; i < 16; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 8);
                acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], 16);
            }
        if (pg == 0 && c < hd) {
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int i = 0; i < 16; i += 4)
                    *reinterpret_cast<float4*>(&red[warp][r][c + i]) =
                        make_float4(acc[r][i], acc[r][i + 1], acc[r][i + 2], acc[r][i + 3]);
        }
    }
    __syncthreads();
    for (int idx = tid; idx < R * hd; idx += kThreads) {
        const int r = idx / hd, d = idx % hd;
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += red[w][r][d];
        acc_out[idx] = o;
    }
}

__global__ void __launch_bounds__(kThreads) decode_q8_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ valid, __nv_bfloat16* __restrict__ out,  // (B, KV, R, hd)
    int KV, int R, int T, int hd, int NS) {
    const int g = blockIdx.x, b = blockIdx.y;
    const int vl = max(min(valid[b], T), 0);
    const int live = (vl + kSplit - 1) / kSplit;  // 0 when valid == 0 -> zeros
    const size_t bg = static_cast<size_t>(b) * KV + g;
    for (int r = 0; r < R; ++r) {
        float M = -INFINITY;
        for (int s = 0; s < live; ++s) M = fmaxf(M, part_ml[((bg * NS + s) * R + r) * 2]);
        float L = 0.f;
        for (int s = 0; s < live; ++s) {
            const float* ml = part_ml + ((bg * NS + s) * R + r) * 2;
            L += ml[1] * expf(ml[0] - M);
        }
        const float inv = 1.f / fmaxf(L, 1e-30f);
        for (int d = threadIdx.x; d < hd; d += kThreads) {
            float o = 0.f;
            for (int s = 0; s < live; ++s) {
                const float w = expf(part_ml[((bg * NS + s) * R + r) * 2] - M);
                o = fmaf(part_acc[((bg * NS + s) * R + r) * hd + d], w, o);
            }
            out[(bg * R + r) * hd + d] = f2bf(o * inv);
        }
    }
}

template <int R, bool kMxu>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q, const void* kq,
                         const void* ks, const void* vq, const void* vs, const void* valid,
                         void* part_acc, void* part_ml, int KV, int T, int hd, int NS,
                         float scale) {
    decode_q8_split_kernel<R, kMxu><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
        static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
        static_cast<const float*>(vs), static_cast<const int*>(valid),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml), KV, T, hd, NS, scale);
    return cudaGetLastError();
}

template <bool kMxu>
int run(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
        const void* valid, void* out, void* part_acc, void* part_ml, int B, int KV, int R, int T,
        int hd, void* stream) {
    if (B <= 0 || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 || hd > kMaxHd ||
        hd % 16 != 0)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int NS = (T + kSplit - 1) / kSplit;
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    const dim3 grid(NS, KV, B);
    cudaError_t err;
    switch (R) {
        case 1: err = launch_split<1, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 2: err = launch_split<2, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 3: err = launch_split<3, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 4: err = launch_split<4, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 5: err = launch_split<5, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 6: err = launch_split<6, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        case 7: err = launch_split<7, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
        default: err = launch_split<8, kMxu>(grid, st, q, kq, ks, vq, vs, valid, part_acc, part_ml, KV, T, hd, NS, scale); break;
    }
    if (err != cudaSuccess) return err;
    decode_q8_combine_kernel<<<dim3(KV, B), kThreads, 0, st>>>(
        static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
        static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(out), KV, R, T, hd, NS);
    return cudaGetLastError();
}

}  // namespace

PREGO_EXPORT int prego_decode_attention_q8_splits(int T) { return (T + kSplit - 1) / kSplit; }

// out (B, KV, R, hd) bf16 from q (B, KV, R, hd) bf16, the int8 cache kq/vq
// (B, KV, T, hd) with f32 scales ks/vs (B, KV, T), and valid (B,) int32, all
// on the device. part_acc (B, KV, NS, R, hd) and part_ml (B, KV, NS, R, 2)
// are f32 scratch, NS = ceil(T / 64). hd a multiple of 16, at most 256.
PREGO_EXPORT int prego_decode_attention_q8(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* valid,
                                           void* out, void* part_acc, void* part_ml, int B,
                                           int KV, int R, int T, int hd, void* stream) {
    return run<false>(q, kq, ks, vq, vs, valid, out, part_acc, part_ml, B, KV, R, T, hd, stream);
}

// K3m: the int8_mxu=True mode, the arguments of K3.
PREGO_EXPORT int prego_decode_attention_q8_mxu(const void* q, const void* kq, const void* ks,
                                               const void* vq, const void* vs,
                                               const void* valid, void* out, void* part_acc,
                                               void* part_ml, int B, int KV, int R, int T, int hd,
                                               void* stream) {
    return run<true>(q, kq, ks, vq, vs, valid, out, part_acc, part_ml, B, KV, R, T, hd, stream);
}
