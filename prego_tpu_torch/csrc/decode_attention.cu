// K2: bounded single-token GQA decode attention on Hopper.
//
// Replaces prego_tpu/ops/decode_attention.py:728 decode_attention_bounded
// and its three Pallas bodies (_decode_kernel_bounded + _bounded_walk,
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
// ratio, so it is memory bound; and, called once a layer a step, its
// launches and allocations on the host weigh as much as its device time.
//
// Design: one launch, and the wrapper allocates only the output. The grid
// is (C, KV, B) with clusters of (C, 1, 1), C = min(8, ceil(T / 64), 8 x
// SMs / (B x KV)): the C blocks of a cluster share one (b, g), each a
// contiguous range of ceil(T / C) positions (64 at T 512 and B x KV <= 132;
// 128 at the 7B shape at B 8, where clusters of 8 would run in three
// waves, each as slow as its slowest block). A block streams the part of its
// range below valid[b] through a ring of two 16 KB stages in shared memory,
// each stage one bulk copy (cp.async.bulk, completing on an mbarrier) of up
// to 8192 / hd consecutive cache rows: first its keys, then its values, so
// traffic follows occupancy and valid stays on the device (no host sync;
// graph-capturable). Scores take tpp = hd / 32 threads a position (16-byte
// reads of the staged key row, joined by shuffles) and stay in shared
// memory; then the block's max m, p = exp(s - m) and l = sum p in f32; then
// acc = sum_t bf16(p_t) v_t, each thread 4 channels of every (128 / (hd /
// 4))-th position, the groups added in a fixed order. p is rounded against
// the block's max, as the split kernels round it against a split's. Each
// block publishes (m, l, acc) in its shared memory; after a cluster barrier
// the blocks merge the C ranks in rank order with the log-sum-exp rule
// through distributed shared memory, each an equal slice of the R x hd
// outputs, and write bf16; a second cluster barrier keeps every rank's
// shared memory until its peers have read it. A block whose range starts at
// or past valid[b] still reaches both barriers and publishes m = -inf,
// l = 0; a (b, g) with no live rank writes zeros. No atomics: the same bits
// every run.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;      // query rows per kv head
constexpr int kMaxHd = 256;   // head dim
constexpr int kMaxCluster = 8;
constexpr int kSplit = 64;    // positions a block at least (T / 64 blocks up to 8)
constexpr int kRing = 2;
constexpr int kStageBytes = 16384;
constexpr int kMaxSmem = 232448;  // the H100's per-block limit

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// The dynamic shared memory of a block: the ring, its barriers, q in f32,
// the scores (R x P), the PV groups' partial sums, and what the block
// publishes to its cluster (acc R x hd, then m and l per row).
struct Smem {
    int bars, q, s, red, acc, ml, total;
    __host__ __device__ Smem(int R, int hd, int P) {
        bars = kRing * kStageBytes;
        q = bars + align16(kRing * 8);
        s = q + align16(R * hd * 4);
        red = s + align16(R * P * 4);
        acc = red + align16((kThreads / (hd / 4)) * R * hd * 4);
        ml = acc + align16(R * hd * 4);
        total = ml + align16(2 * R * 4);
    }
};

__global__ void __launch_bounds__(kThreads) decode_cluster_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, KV, R, hd)
    const __nv_bfloat16* __restrict__ k,  // (B, KV, T, hd)
    const __nv_bfloat16* __restrict__ v,  // (B, KV, T, hd)
    const int* __restrict__ valid,        // (B,)
    __nv_bfloat16* __restrict__ out,      // (B, KV, R, hd)
    int KV, int R, int T, int hd, int P, float scale) {
    using namespace hopper;
    extern __shared__ __align__(128) uint8_t smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());  // blockIdx.x
    const int g = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const Smem L(R, hd, P);
    float* q_s = reinterpret_cast<float*>(smem + L.q);
    float* s_s = reinterpret_cast<float*>(smem + L.s);
    float* red = reinterpret_cast<float*>(smem + L.red);
    float* acc_s = reinterpret_cast<float*>(smem + L.acc);
    float* ml_s = reinterpret_cast<float*>(smem + L.ml);
    const uint32_t ring = smem_u32(smem), bars = ring + L.bars;

    const size_t bg = static_cast<size_t>(b) * KV + g;
    const int vl = max(0, min(valid[b], T));
    const int t0 = rank * P, n = min(P, vl - t0);  // n <= 0: nothing live here
    const int rows = kStageBytes / (2 * hd);       // cache rows a stage
    const int nchunks = n > 0 ? (n + rows - 1) / rows : 0, nseq = 2 * nchunks;
    const __nv_bfloat16* kb = k + (bg * T + t0) * hd;
    const __nv_bfloat16* vb = v + (bg * T + t0) * hd;

    if (tid == 0) {
        for (int i = 0; i < kRing; ++i) mbar_init(bars + 8 * i, 1);
        fence_mbarrier_init();
    }
    __syncthreads();
    // item i of the sequence (the key chunks, then the value chunks) into
    // slot i % kRing: one bulk copy of its contiguous rows
    auto issue = [&](int i) {
        const bool is_v = i >= nchunks;
        const int r0 = (is_v ? i - nchunks : i) * rows;
        const uint32_t bytes = static_cast<uint32_t>(min(rows, n - r0) * hd * 2);
        const uint32_t bar = bars + 8 * (i % kRing);
        mbar_arrive_expect_tx(bar, bytes);
        bulk_load(ring + (i % kRing) * kStageBytes, (is_v ? vb : kb) + static_cast<size_t>(r0) * hd,
                  bytes, bar);
    };
    if (tid == 0)
        for (int i = 0; i < min(kRing, nseq); ++i) issue(i);
    for (int idx = tid; idx < R * hd; idx += kThreads) q_s[idx] = bf2f(q[bg * R * hd + idx]);
    __syncthreads();

    const int tpp = hd >= 256 ? 8 : hd >= 128 ? 4 : hd >= 64 ? 2 : 1;  // threads a score
    const int tpr = hd / 4, pg = kThreads / tpr;  // PV: threads a value row, row groups
    const int pgi = tid / tpr, cgi = tid % tpr;
    float acc[kMaxR][4];
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

    for (int i = 0; i < nseq; ++i) {
        const int slot = i % kRing;
        mbar_wait(bars + 8 * slot, (i / kRing) & 1);
        const __nv_bfloat16* buf = reinterpret_cast<const __nv_bfloat16*>(smem + slot * kStageBytes);
        if (i < nchunks) {
            // scores of this chunk's positions: tpp threads a position, each
            // over alternate 8-channel pieces of the key row, joined by shuffles
            const int r0 = i * rows, nr = min(rows, n - r0);
            for (int j0 = 0; j0 < nr; j0 += kThreads / tpp) {
                const int j = j0 + tid / tpp, part = tid % tpp;
                float dot[kMaxR];
#pragma unroll
                for (int r = 0; r < kMaxR; ++r) dot[r] = 0.f;
                if (j < nr) {
                    const __nv_bfloat16* krow = buf + static_cast<size_t>(j) * hd;
                    for (int d = part * 8; d < hd; d += tpp * 8) {
                        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
                        const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float2 kv = bf16x2_to_float2(w[e]);
#pragma unroll
                            for (int r = 0; r < kMaxR; ++r)
                                if (r < R)
                                    dot[r] = fmaf(q_s[r * hd + d + 2 * e + 1], kv.y,
                                                  fmaf(q_s[r * hd + d + 2 * e], kv.x, dot[r]));
                        }
                    }
                }
                for (int off = tpp / 2; off > 0; off >>= 1)
#pragma unroll
                    for (int r = 0; r < kMaxR; ++r)
                        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
                if (part == 0 && j < nr)
#pragma unroll
                    for (int r = 0; r < kMaxR; ++r)
                        if (r < R) s_s[r * P + r0 + j] = dot[r] * scale;
            }
        } else if (pgi < pg) {
            // acc[r][4 channels] += bf16(p[r][t]) v[t] over the chunk's
            // positions t = pgi, pgi + pg, ...
            const int r0 = (i - nchunks) * rows, nr = min(rows, n - r0);
            for (int j = pgi; j < nr; j += pg) {
                const uint2 raw =
                    *reinterpret_cast<const uint2*>(buf + static_cast<size_t>(j) * hd + cgi * 4);
                const float2 v01 = bf16x2_to_float2(raw.x), v23 = bf16x2_to_float2(raw.y);
#pragma unroll
                for (int r = 0; r < kMaxR; ++r) {
                    if (r < R) {
                        const float p = round_bf16(s_s[r * P + r0 + j]);
                        acc[r][0] = fmaf(p, v01.x, acc[r][0]);
                        acc[r][1] = fmaf(p, v01.y, acc[r][1]);
                        acc[r][2] = fmaf(p, v23.x, acc[r][2]);
                        acc[r][3] = fmaf(p, v23.y, acc[r][3]);
                    }
                }
            }
        }
        __syncthreads();  // the slot's readers are done, the chunk's scores written
        if (tid == 0 && i + kRing < nseq) issue(i + kRing);
        if (i == nchunks - 1) {
            // the block's softmax statistics: one warp per query row
            for (int r = warp; r < R; r += kWarps) {
                float m = -INFINITY;
                for (int j = lane; j < n; j += 32) m = fmaxf(m, s_s[r * P + j]);
                m = warp_max(m);
                float l = 0.f;
                for (int j = lane; j < n; j += 32) {
                    const float p = expf(s_s[r * P + j] - m);
                    s_s[r * P + j] = p;
                    l += p;
                }
                l = warp_sum(l);
                if (lane == 0) {
                    ml_s[2 * r] = m;
                    ml_s[2 * r + 1] = l;
                }
            }
            __syncthreads();
        }
    }

    // publish (m, l, acc): the PV groups' sums added in group order
    if (n > 0) {
        if (pgi < pg)
#pragma unroll
            for (int r = 0; r < kMaxR; ++r)
                if (r < R)
                    *reinterpret_cast<float4*>(&red[(pgi * R + r) * hd + cgi * 4]) =
                        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        __syncthreads();
        for (int idx = tid; idx < R * hd; idx += kThreads) {
            float o = 0.f;
            for (int w = 0; w < pg; ++w) o += red[w * R * hd + idx];
            acc_s[idx] = o;
        }
    } else if (tid < R) {
        ml_s[2 * tid] = -INFINITY;
        ml_s[2 * tid + 1] = 0.f;
    }
    cluster.sync();  // every rank has published

    // merge the C ranks in rank order, each block a slice of the outputs
    const int total = R * hd, per = (total + C - 1) / C;
    const int i1 = min(total, (rank + 1) * per);
    for (int idx = rank * per + tid; idx < i1; idx += kThreads) {
        const int r = idx / hd;
        // every rank's (m, l, acc) first, all remote reads in flight at once
        float mc[kMaxCluster], lc[kMaxCluster], ac[kMaxCluster];
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
            if (c < C) {
                const float* ml = cluster.map_shared_rank(ml_s, c);
                mc[c] = ml[2 * r];
                lc[c] = ml[2 * r + 1];
                ac[c] = cluster.map_shared_rank(acc_s, c)[idx];
            }
        }
        float M = -INFINITY;
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c)
            if (c < C) M = fmaxf(M, mc[c]);
        float o = 0.f;
        if (M > -INFINITY) {  // else no position of (b, g) is valid: zeros
            float l = 0.f;
#pragma unroll
            for (int c = 0; c < kMaxCluster; ++c) {
                if (c >= C || mc[c] == -INFINITY) continue;  // a rank with nothing live
                const float w = expf(mc[c] - M);
                l += lc[c] * w;
                o = fmaf(ac[c], w, o);
            }
            o *= 1.f / fmaxf(l, 1e-30f);
        }
        out[bg * R * hd + idx] = f2bf(o);
    }
    cluster.sync();  // no rank's shared memory goes while a peer reads it
}

}  // namespace

// out (B, KV, R, hd) bf16 from q (B, KV, R, hd), cache k/v (B, KV, T, hd)
// bf16 and valid (B,) int32 on the device, one launch. R <= 8; hd a
// multiple of 16, at most 256; the block's scores (R x ceil(T / C) f32)
// must fit its shared memory beside the ring.
PREGO_EXPORT int prego_decode_attention(const void* q, const void* k, const void* v,
                                        const void* valid, void* out, int B, int KV, int R, int T,
                                        int hd, void* stream) {
    if (B <= 0 || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 || hd > kMaxHd ||
        hd % 16 != 0 || B > 65535 || KV > 65535)
        return PREGO_BAD_ARGUMENT;
    // clusters of up to 8, fewer where B x KV clusters of 8 would not run
    // at once (about 8 blocks an SM): every block of a cluster waits for its
    // slowest, so fewer, longer blocks then finish sooner
    const long long fit = 8LL * hopper::num_sms() / (static_cast<long long>(B) * KV);
    int C = (T + kSplit - 1) / kSplit;
    C = C < kMaxCluster ? C : kMaxCluster;
    C = fit < C ? (fit > 1 ? static_cast<int>(fit) : 1) : C;
    const int P = (T + C - 1) / C;
    const int bytes = Smem(R, hd, P).total;
    if (bytes > kMaxSmem) return PREGO_BAD_ARGUMENT;
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return attr;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, KV, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, decode_cluster_kernel, static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(out), KV, R, T, hd, P,
        1.f / sqrtf(static_cast<float>(hd)));
    return err != cudaSuccess ? err : cudaGetLastError();
}
