// Pass 1 of split-K flash decoding and the log-sum-exp merge of K8 / K8u
// (decode_attention_wo.cu).
//
// Pass 1 runs one block per (split, g, b); a split is kSplit = 64
// consecutive positions. A block whose split starts at or past valid[b]
// returns at once, so traffic follows occupancy and valid stays on the
// device (no host sync). A live block computes its scores (two threads per
// position, 16-byte loads of the key row), the split's max m, p = exp(s -
// m) and l = sum p in f32, then acc = sum_t bf16(p_t) v_t (each warp a
// quarter of the positions, lanes over channels, the quarters added in a
// fixed order), and writes (acc, m, l). The merge combines the live splits
// of each (b, g, r) with the log-sum-exp rule, in split order. No atomics:
// the result does not depend on block order.
//
// kUpd (K8u): the bound arrives as this token's position pos (valid = pos
// + 1). The one block per (b, g) whose split holds pos writes k_new/v_new
// into cache row pos and takes that position's key and value from k_new/
// v_new, not from the cache. No other block reads or writes that row, so
// no ordering across blocks is needed, and the cache afterwards equals
// write-then-attend bit for bit.
//
// Every pass-1 block first lets the launch that depends on it start
// (hopper::launch_dependents), so that K8's projection blocks, launched as
// its programmatic dependents, stream their weights beside pass 1.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace decode_split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;   // cache positions per pass-1 block
constexpr int kMaxR = 8;     // query rows per kv head
constexpr int kMaxHd = 256;  // head dim

inline int num_splits(int T) { return (T + kSplit - 1) / kSplit; }

// The token's new key and value rows (K8u): (B, KV, hd) each, with batch
// strides in elements, so that views into the qkv activations need no
// copy.
struct NewKV {
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    long long k_stride, v_stride;
};

template <bool kUpd>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, KV, R, hd)
    const __nv_bfloat16* __restrict__ k,  // (B, KV, T, hd)
    const __nv_bfloat16* __restrict__ v,  // (B, KV, T, hd)
    const int* __restrict__ valid,        // (B,): the bound, or pos under kUpd
    float* __restrict__ part_acc,         // (B, KV, NS, R, hd)
    float* __restrict__ part_ml,          // (B, KV, NS, R, 2)
    int KV, int R, int T, int hd, int NS, float scale,
    NewKV nkv,                // kUpd only
    __nv_bfloat16* k_cache,   // kUpd only: k and v, written at row pos
    __nv_bfloat16* v_cache) {
    hopper::launch_dependents();
    const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int pos = kUpd ? valid[b] : -1;
    const int vl = min(kUpd ? pos + 1 : valid[b], T);
    const int t0 = s * kSplit;
    if (t0 >= vl) return;  // never read: the merge only takes splits below vl
    const int n = min(kSplit, vl - t0);
    const int jpos = pos - t0;  // pos's row in this split (kUpd), else out of range

    __shared__ float q_s[kMaxR][kMaxHd];
    __shared__ float p_s[kMaxR][kSplit];
    __shared__ __align__(16) float red[kWarps][kMaxR][kMaxHd];  // PV partial sums per warp
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t bg = static_cast<size_t>(b) * KV + g;
    const __nv_bfloat16* knew = nullptr;
    const __nv_bfloat16* vnew = nullptr;
    if constexpr (kUpd) {
        knew = nkv.k + b * nkv.k_stride + static_cast<long long>(g) * hd;
        vnew = nkv.v + b * nkv.v_stride + static_cast<long long>(g) * hd;
        if (jpos >= 0 && jpos < n) {  // this split holds pos: write its row
            const size_t row = (bg * T + pos) * hd;
            for (int i = tid; i < hd / 8; i += kThreads) {
                reinterpret_cast<uint4*>(k_cache + row)[i] = reinterpret_cast<const uint4*>(knew)[i];
                reinterpret_cast<uint4*>(v_cache + row)[i] = reinterpret_cast<const uint4*>(vnew)[i];
            }
        }
    }

    for (int idx = tid; idx < R * hd; idx += kThreads)
        q_s[idx / hd][idx % hd] = bf2f(q[bg * R * hd + idx]);
    __syncthreads();

    // scores: two threads per position, each over alternate 8-channel
    // chunks of the key row (16-byte loads, all issued before any sum
    // needs them), joined with one shuffle
    const __nv_bfloat16* kb = k + (bg * T + t0) * hd;
    {
        const int j = tid >> 1, half = tid & 1;
        float part[kMaxR];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) part[r] = 0.f;
        if (j < n) {
            const __nv_bfloat16* krow =
                (kUpd && j == jpos) ? knew : kb + static_cast<size_t>(j) * hd;
#pragma unroll 4
            for (int d = half * 8; d < hd; d += 16) {
                const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
                const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float2 kv = bf16x2_to_float2(w[i]);
#pragma unroll
                    for (int r = 0; r < kMaxR; ++r)
                        if (r < R)
                            part[r] = fmaf(q_s[r][d + 2 * i + 1], kv.y,
                                           fmaf(q_s[r][d + 2 * i], kv.x, part[r]));
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], 1);
            if (r < R && j < n && half == 0) p_s[r][j] = part[r] * scale;
        }
    }
    __syncthreads();

    // split-local softmax statistics: one warp per query row
    float* ml = part_ml + ((bg * NS + s) * R) * 2;
    for (int r = warp; r < R; r += kWarps) {
        const float a = lane < n ? p_s[r][lane] : -INFINITY;
        const float c = lane + 32 < n ? p_s[r][lane + 32] : -INFINITY;
        const float m = warp_max(fmaxf(a, c));
        const float pa = lane < n ? expf(a - m) : 0.f;
        const float pc = lane + 32 < n ? expf(c - m) : 0.f;
        p_s[r][lane] = pa;
        p_s[r][lane + 32] = pc;
        const float l = warp_sum(pa + pc);
        if (lane == 0) {
            ml[r * 2] = m;
            ml[r * 2 + 1] = l;
        }
    }
    __syncthreads();

    // acc[r][d] = sum_t bf16(p[r][t]) * v[t][d]: warp w takes the split's
    // positions [16w, 16w + 16), each lane 4 channels at a time (a warp
    // reads 256 contiguous bytes of a value row); the 4 warps' partial sums
    // are then added in warp order
    const __nv_bfloat16* vb = v + (bg * T + t0) * hd;
    const int j0 = warp * (kSplit / kWarps), j1 = min(n, j0 + kSplit / kWarps);
    for (int c = lane * 4; c < hd; c += 128) {
        float acc[kMaxR][4];
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
            const __nv_bfloat16* vrow =
                (kUpd && j == jpos) ? vnew : vb + static_cast<size_t>(j) * hd;
            const uint2 raw = *reinterpret_cast<const uint2*>(vrow + c);
            const float2 v01 = bf16x2_to_float2(raw.x), v23 = bf16x2_to_float2(raw.y);
#pragma unroll
            for (int r = 0; r < kMaxR; ++r) {
                if (r < R) {
                    const float p = round_bf16(p_s[r][j]);
                    acc[r][0] = fmaf(p, v01.x, acc[r][0]);
                    acc[r][1] = fmaf(p, v01.y, acc[r][1]);
                    acc[r][2] = fmaf(p, v23.x, acc[r][2]);
                    acc[r][3] = fmaf(p, v23.y, acc[r][3]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
            if (r < R)
                *reinterpret_cast<float4*>(&red[warp][r][c]) =
                    make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
    float* acc_out = part_acc + ((bg * NS + s) * R) * hd;
    for (int idx = tid; idx < R * hd; idx += kThreads) {
        const int r = idx / hd, d = idx % hd;
        float o = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) o += red[w][r][d];
        acc_out[idx] = o;
    }
}

// The number of live splits of row b: 0 when its bound is 0 (zeros out).
__device__ __forceinline__ int live_splits(int valid, int T) {
    return (max(min(valid, T), 0) + kSplit - 1) / kSplit;
}

// The merge statistics of (bg, r) over its `live` splits: the max M and
// 1 / max(L, 1e-30), L = sum_s l_s exp(m_s - M). The merge reads pass 1's
// partial sums through plain pointers: its kernel may have started before
// pass 1 ended (a programmatic dependent launch).
__device__ __forceinline__ float2 merge_stats(const float* part_ml, size_t bg,
                                              int r, int R, int NS, int live) {
    float M = -INFINITY;
    for (int s = 0; s < live; ++s) M = fmaxf(M, part_ml[((bg * NS + s) * R + r) * 2]);
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
        const float* ml = part_ml + ((bg * NS + s) * R + r) * 2;
        L += ml[1] * expf(ml[0] - M);
    }
    return make_float2(M, 1.f / fmaxf(L, 1e-30f));
}

// The normalised output channel d of (bg, r), rounded to bf16.
__device__ __forceinline__ __nv_bfloat16 merge_value(const float* part_acc,
                                                     const float* part_ml,
                                                     size_t bg, int r, int d, int R, int hd,
                                                     int NS, int live, float2 stats) {
    float o = 0.f;
    for (int s = 0; s < live; ++s) {
        const float w = expf(part_ml[((bg * NS + s) * R + r) * 2] - stats.x);
        o = fmaf(part_acc[((bg * NS + s) * R + r) * hd + d], w, o);
    }
    return f2bf(o * stats.y);
}

}  // namespace decode_split
