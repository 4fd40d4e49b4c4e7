// K2: bounded single-token GQA decode attention on Hopper.
//
// Replaces prego_tpu/ops/decode_attention.py::decode_attention_bounded and
// its three Pallas bodies (_decode_kernel_bounded + _bounded_walk,
// _decode_kernel_bounded_fold, _decode_kernel_bounded_fold_flat +
// _flat_group_update). Those are TPU scheduling variants of one function:
// for each row b and kv head g, the R query rows of q[b, g] attend over
// cache positions t < valid[b] with a softmax, reading only the blocks
// that hold valid positions. Semantics kept from the Pallas bodies:
// masked positions contribute nothing; valid == 0 gives zeros, not NaN;
// p is cast to the cache dtype before the PV product while the normaliser
// l sums the f32 p; the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it here: one decode step reads K and V once (2 x B x KV x
// valid x hd bf16; 8 MB per layer at B = 8, 32 heads, 512 positions) and
// does 4 FLOPs per element read: far below the card's compute-to-bytes
// ratio, so it is memory bound and the work is to keep enough bytes in
// flight. With B x KV = 256 (b, g) pairs at the 7B shape, one block per
// pair would leave the walk over T serial inside each block.
//
// Design: split-K flash decoding. Pass 1 runs one block per (split, g, b);
// a split is kSplit = 64 consecutive positions. A block whose split starts
// at or past valid[b] returns at once, so traffic follows occupancy and
// valid stays on the device (no host sync). A live block computes its
// scores (two threads per position, 16-byte loads of the key row), the
// split's max m, p = exp(s - m) and l = sum p in f32, then acc = sum_t
// bf16(p_t) v_t (each warp a quarter of the positions, lanes over
// channels, the quarters added in a fixed order), and writes (acc, m, l).
// Pass 2 merges the live splits of each (b, g) with the log-sum-exp rule.
// No atomics: the result does not depend on block order. A block is a
// short chain of dependent loads (q, then keys, then values), and every
// load of a phase is issued before the first is needed: with the decode
// shapes' few blocks, per-block latency, not bandwidth, sets the time.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;   // cache positions per pass-1 block
constexpr int kMaxR = 8;     // query rows per kv head
constexpr int kMaxHd = 256;  // head dim

__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, KV, R, hd)
    const __nv_bfloat16* __restrict__ k,  // (B, KV, T, hd)
    const __nv_bfloat16* __restrict__ v,  // (B, KV, T, hd)
    const int* __restrict__ valid,        // (B,)
    float* __restrict__ part_acc,         // (B, KV, NS, R, hd)
    float* __restrict__ part_ml,          // (B, KV, NS, R, 2)
    int KV, int R, int T, int hd, int NS, float scale) {
    const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
    const int vl = min(valid[b], T);
    const int t0 = s * kSplit;
    if (t0 >= vl) return;  // never read: pass 2 only merges splits below vl
    const int n = min(kSplit, vl - t0);

    __shared__ float q_s[kMaxR][kMaxHd];
    __shared__ float p_s[kMaxR][kSplit];
    __shared__ __align__(16) float red[kWarps][kMaxR][kMaxHd];  // PV partial sums per warp
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t bg = static_cast<size_t>(b) * KV + g;

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
            const __nv_bfloat16* krow = kb + static_cast<size_t>(j) * hd;
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
            const uint2 raw = *reinterpret_cast<const uint2*>(vb + static_cast<size_t>(j) * hd + c);
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

__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
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

}  // namespace

PREGO_EXPORT int prego_decode_attention_splits(int T) { return (T + kSplit - 1) / kSplit; }

// out (B, KV, R, hd) bf16 from q (B, KV, R, hd), cache k/v (B, KV, T, hd)
// bf16 and valid (B,) int32 on the device. part_acc (B, KV, NS, R, hd) and
// part_ml (B, KV, NS, R, 2) are f32 scratch, NS = ceil(T / 64).
PREGO_EXPORT int prego_decode_attention(const void* q, const void* k, const void* v,
                                        const void* valid, void* out, void* part_acc,
                                        void* part_ml, int B, int KV, int R, int T, int hd,
                                        void* stream) {
    if (B <= 0 || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 || hd > kMaxHd ||
        hd % 16 != 0)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int NS = prego_decode_attention_splits(T);
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    decode_split_kernel<<<dim3(NS, KV, B), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml), KV, R, T, hd, NS, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<<<dim3(KV, B), kThreads, 0, s>>>(
        static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
        static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(out), KV, R, T, hd, NS);
    return cudaGetLastError();
}
