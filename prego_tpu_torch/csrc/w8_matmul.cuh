// K4's two int8-weight products (int8_matmul.cu), shared with K9
// (fused_dense_q8.cu): y (M, N) = bf16(x) (M, K) . q (K, N) int8, f32.
// Replaces prego_tpu/ops/quant.py:80 int8_matmul (Pallas body
// _int8_matmul_kernel). Every bf16 x int8 product is exact in f32 (|q| <=
// 127 fits bf16's significand); the sums are f32, so designs differ only in
// the order of the sums.
//
// M <= 8, the streaming GEMV (w8_gemv_kernel). Bound by bytes: each weight
// byte is used M times, so the call streams K N int8 bytes once (a 7B decode
// step's five projections at M 1: 0.0997 ms at 3.35 TB/s), and on the host
// by its launches: a 7B int8 decode step makes ~225 such calls. A block
// owns 128 output columns and one split of K; each thread reads 8
// consecutive int8 columns of a row (an 8-byte load; a warp reads two
// 128-byte row segments) for M rows of x staged in shared memory 256 rows at
// a time, converts the bytes to f32 exactly (common.cuh) and uses f32 FMAs.
// The 16 row groups of a block are summed with a shuffle and through shared
// memory in a fixed order. The S splits of K are then summed in split order
// in one of two ways, a compile-time flag:
//   kCluster (K4): the S blocks of a column tile run as one thread block
//     cluster (grid (tiles, S), cluster (1, S)); each keeps its (M, 128)
//     partial sums in shared memory and, after a cluster barrier, each sums
//     an equal slice of them over the S ranks through distributed shared
//     memory, applies the column scale and writes out. A second cluster
//     barrier keeps every rank's shared memory alive until its peers have
//     read it. One launch and no scratch.
//   otherwise (K9): each split writes (M, N) partial sums to a scratch
//     (S, M, N) that the caller's second launch sums in split order.
// Either way no atomics: the same bits every run, and the same bits in both.
//
// M > 8, the tile path (w8_wgmma_kernel). Bound by operations (w13 at M 512:
// 92.3 GFLOP, 0.0934 ms at 989 TFLOP/s bf16), which only wgmma reaches on
// this card. Tiles of BM x 128 outputs, BM = 64 x the consumer warpgroups:
// 64 up to M 64; else 256 where that takes fewer waves of blocks than 128
// (launch_tile), else 128.
// A producer warp keeps a ring of stages of depth 64 in flight (3 with one
// warpgroup, so that two blocks share an SM; 4 otherwise), each tracked by
// a full and an empty mbarrier: x's tile (BM x 64 bf16) by TMA with the
// 128-byte swizzle, q's tile (64 x 128 int8) by TMA too, unswizzled, where
// N is a multiple of 16 (every model shape), and by 8-byte cp.asyncs where
// it is not (a tensor map wants 16-byte row strides); zeros past the K, M
// and N edges. For each stage the consumers first convert q's tile to bf16
// exactly, together, into one of three buffers in the layout wgmma reads
// as an MN-major B operand (n contiguous, 128-byte swizzle: the transpose
// bit, so no transpose is needed); then fence.proxy.async and a named
// barrier over the consumers; then wgmma m64n128k16, A (x) and B both from
// shared memory, 4 a stage, committed as one group. Each consumer
// warpgroup waits for its previous group only (wgmma.wait_group 1), so one
// stage's products run while the next stage's weights are converted, and
// then releases that stage. A weight tile is converted once per BM output
// rows: the conversion's shared-memory traffic, beside wgmma's operand
// reads, is what the taller tile saves. Three conversion buffers: a buffer
// is rewritten two stages after its products were issued, and every
// warpgroup has waited for them before the named barrier in between. The
// epilogue scales the columns in f32 and stores f32, masked at the ragged M
// and N edges. Raw PTX (hopper.cuh), as the repo's other kernels, rather
// than CuTe: the kernel needs a few instruction forms and two descriptors.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace w8 {
// Internal linkage: each library that includes this header keeps its own
// kernels and its own once-per-process launch state (a function-local
// static of an inline function would otherwise be one object across every
// library loaded, and set only one library's kernel attributes).
namespace {

// ---- M <= 8: the streaming GEMV ----

constexpr int kMaxM = 8;
constexpr int kThreads = 256;
constexpr int kCols = 8;                          // columns a thread, one 8-byte load
constexpr int kColGroups = 16;
constexpr int kTileN = kColGroups * kCols;        // 128 columns a block
constexpr int kRowGroups = kThreads / kColGroups;  // 16
constexpr int kChunk = 256;                       // rows of x staged at a time
constexpr int kSplitAlign = 64;                   // a split's rows: a multiple of this
constexpr int kTargetBlocks = 4 * 132;            // about 4 blocks per SM
constexpr int kMaxClusterSplits = 16;             // the H100's non-portable cluster limit

inline int split_rows(int K, int splits) {
    const int rows = (K + splits - 1) / splits;
    return (rows + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
}

// splits of K so that about kTargetBlocks blocks run, at most max_splits
inline int num_splits(int K, int N, int max_splits = 1 << 30) {
    const int tiles = (N + kTileN - 1) / kTileN;
    int s = (kTargetBlocks + tiles - 1) / tiles;
    const int max_s = K / 256 > 1 ? K / 256 : 1;
    s = s < max_s ? s : max_s;
    s = s < max_splits ? s : max_splits;
    const int rows = split_rows(K, s);
    return (K + rows - 1) / rows;
}

// Partial sums of x (M, K) bf16 . q (K, N) int8 over the split
// blockIdx.y's rows, f32. kCluster: summed over the cluster's splits in
// split order, scaled and written to out (M, N); otherwise written unscaled
// to part[split] (S, M, N).
template <int M, bool kCluster>
__global__ void __launch_bounds__(kThreads) w8_gemv_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const int8_t* __restrict__ q,          // (K, N)
    float* __restrict__ part,              // (S, M, N), !kCluster
    const float* __restrict__ scale,       // (N,), kCluster
    float* __restrict__ out,               // (M, N), kCluster
    int K, int N, int rows_per_split) {
    __shared__ float xs[kChunk][M];
    __shared__ float red[kRowGroups / 2][M][kTileN];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = tid % kColGroups, rg = tid / kColGroups;
    const int n0 = blockIdx.x * kTileN, n = n0 + cg * kCols;
    const int split = blockIdx.y;
    const int kb = split * rows_per_split, ke = min(K, kb + rows_per_split);
    float acc[M][kCols];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;
    for (int c0 = kb; c0 < ke; c0 += kChunk) {
        const int clen = min(kChunk, ke - c0);
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < M * clen; i += kThreads) {
            const int m = i / clen, kk = i % clen;
            xs[kk][m] = bf2f(x[static_cast<size_t>(m) * K + c0 + kk]);
        }
        __syncthreads();
        if (n < N) {
            const int8_t* qc = q + static_cast<size_t>(c0) * N + n;
#pragma unroll 4
            for (int kk = rg; kk < clen; kk += kRowGroups) {
                const uint2 raw = *reinterpret_cast<const uint2*>(qc + static_cast<size_t>(kk) * N);
                float w[kCols];
                int8x4_to_float(raw.x, w);
                int8x4_to_float(raw.y, w + 4);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const float xv = xs[kk][m];
#pragma unroll
                    for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
                }
            }
        }
    }
    // the two row groups of a warp (lanes 0-15, 16-31), then the warps in order
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if (lane < 16) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < kCols; ++j) red[warp][m][cg * kCols + j] = acc[m][j];
    }
    __syncthreads();
    if constexpr (!kCluster) {
        for (int i = tid; i < M * kTileN; i += kThreads) {
            const int m = i / kTileN, c = i % kTileN;
            if (n0 + c >= N) continue;
            float y = 0.f;
#pragma unroll
            for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][m][c];
            part[(static_cast<size_t>(split) * M + m) * N + n0 + c] = y;
        }
    } else {
        __shared__ float mine[M * kTileN];  // this split's (M, 128) partial sums
        for (int i = tid; i < M * kTileN; i += kThreads) {
            float y = 0.f;
#pragma unroll
            for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][i / kTileN][i % kTileN];
            mine[i] = y;
        }
        cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
        cluster.sync();  // every split's sums are in its shared memory
        // cluster (1, S): rank r is split r; each rank sums a slice of the
        // tile's M x 128 values over the S ranks, in rank order
        const int S = static_cast<int>(cluster.num_blocks());
        const int rank = static_cast<int>(cluster.block_rank());
        const int per = (M * kTileN + S - 1) / S;
        const int i1 = min(M * kTileN, (rank + 1) * per);
        for (int i = rank * per + tid; i < i1; i += kThreads) {
            const int m = i / kTileN, c = i % kTileN;
            if (n0 + c >= N) continue;
            // eight ranks' values at a time, their remote reads in flight
            // together, then added in rank order
            float y = 0.f;
            for (int r0 = 0; r0 < S; r0 += 8) {
                float v[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (r0 + j < S) v[j] = cluster.map_shared_rank(mine, r0 + j)[i];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (r0 + j < S) y += v[j];
            }
            out[static_cast<size_t>(m) * N + n0 + c] = y * scale[n0 + c];
        }
        cluster.sync();  // no rank's shared memory goes while a peer reads it
    }
}

// Launch<M>::run(args...) for the M of the call, 1 <= M <= 8
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_m(int M, Args... args) {
    switch (M) {
        case 1: return Launch<1>::run(args...);
        case 2: return Launch<2>::run(args...);
        case 3: return Launch<3>::run(args...);
        case 4: return Launch<4>::run(args...);
        case 5: return Launch<5>::run(args...);
        case 6: return Launch<6>::run(args...);
        case 7: return Launch<7>::run(args...);
        default: return Launch<8>::run(args...);
    }
}

template <int M>
struct Gemv {
    static cudaError_t run(dim3 grid, cudaStream_t s, const void* x, const void* q, void* part,
                           int K, int N, int rows) {
        w8_gemv_kernel<M, false><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
            static_cast<float*>(part), nullptr, nullptr, K, N, rows);
        return cudaGetLastError();
    }
};

template <int M>
struct GemvCluster {
    static cudaError_t run(dim3 grid, cudaStream_t s, const void* x, const void* q,
                           const void* scale, void* out, int K, int N, int rows) {
        // clusters above 8 blocks are the H100's, not portable
        static const cudaError_t attr = cudaFuncSetAttribute(
            w8_gemv_kernel<M, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (attr != cudaSuccess) return attr;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(kThreads);
        cfg.stream = s;
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = 1;
        at[0].val.clusterDim.y = grid.y;
        at[0].val.clusterDim.z = 1;
        cfg.attrs = at;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, w8_gemv_kernel<M, true>, static_cast<const __nv_bfloat16*>(x),
            static_cast<const int8_t*>(q), static_cast<float*>(nullptr),
            static_cast<const float*>(scale), static_cast<float*>(out), K, N, rows);
        return err != cudaSuccess ? err : cudaGetLastError();
    }
};

// The two-launch streaming path's first launch (K9): part (splits, M, N)
// f32, unscaled, for x (M, K) bf16 and q (K, N) int8, splits =
// num_splits(K, N); K and N multiples of 8, 1 <= M <= 8.
inline cudaError_t launch_gemv(const void* x, const void* q, void* part, int M, int K, int N,
                               int splits, cudaStream_t stream) {
    const dim3 grid((N + kTileN - 1) / kTileN, splits);
    return dispatch_m<Gemv>(M, grid, stream, x, q, part, K, N, split_rows(K, splits));
}

// The one-launch streaming path (K4): out (M, N) f32 = (x . q) * s, the
// splits (1 <= splits <= kMaxClusterSplits) summed in a cluster.
inline cudaError_t launch_gemv_cluster(const void* x, const void* q, const void* s, void* out,
                                       int M, int K, int N, int splits, cudaStream_t stream) {
    const dim3 grid((N + kTileN - 1) / kTileN, splits);
    return dispatch_m<GemvCluster>(M, grid, stream, x, q, s, out, K, N, split_rows(K, splits));
}

// ---- M > 8: the wgmma tile path ----

constexpr int kBN = 128;  // output columns a tile
constexpr int kBK = 64;   // depth a stage: one 128-byte row of x
constexpr int kBBufs = 3;                        // converted weight tiles
constexpr int kQStageBytes = kBK * kBN;          // int8 (k, n), rows of 128 bytes
constexpr int kBBufBytes = kBK * kBN * 2;        // bf16, MN-major, 128-byte swizzle
constexpr int kAtom = 1024;                      // 8 rows of 128 bytes: a swizzle atom

template <int kWG>  // consumer warpgroups, 64 output rows each
struct TileShape {
    static constexpr int BM = 64 * kWG;
    static constexpr int kConsumers = 128 * kWG;
    static constexpr int kThreads = kConsumers + 32;  // and one producer warp
    static constexpr int kChunks = kBK * kBN / 8 / kConsumers;  // 8-byte chunks a thread converts
    // ring stages: with one warpgroup 3, so that two blocks fit an SM
    static constexpr int kStages = kWG == 1 ? 3 : 4;
    static constexpr int kXBytes = BM * kBK * 2;
    static constexpr int kSmem =
        kStages * (kXBytes + kQStageBytes) + kBBufs * kBBufBytes + 2 * kStages * 8 + kAtom;
};

// two floats -> packed bf16 pair, the first in the low half
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned int*>(&v);
}

// acc (64 f32 a thread, the m64n128 f32 fragment) = A (64 x 16 bf16) . B (16 x
// 128 bf16) + (accumulate ? acc : 0), both from shared memory through their
// descriptors; B MN-major (n contiguous, the transpose bit), A K-major
__device__ __forceinline__ void wgmma_m64n128k16_bf16_bmn(float* acc, uint64_t da, uint64_t db,
                                                          int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
          "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
          "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
          "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
          "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
          "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
          "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
          "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
          "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
          "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
          "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
          "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
          "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
          "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
          "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
          "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <int kWG>
__global__ void __launch_bounds__(TileShape<kWG>::kThreads) w8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,  // x (M, K) bf16, boxes of BM x 64
    const __grid_constant__ CUtensorMap tmap_q,  // q (K, N) int8, boxes of 64 x 128; N % 16 == 0
    const int8_t* __restrict__ q, const float* __restrict__ scale, float* __restrict__ out,
    int M, int K, int N) {
    using Shape = TileShape<kWG>;
    using namespace hopper;
    constexpr int kStages = Shape::kStages;
    extern __shared__ uint8_t smem_raw[];
    // the swizzle atoms want 1024-byte alignment
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + kAtom - 1) & ~static_cast<uint32_t>(kAtom - 1);
    uint8_t* smem = smem_raw + (base - raw);
    constexpr int kBOff = kStages * Shape::kXBytes;          // after the x stages
    constexpr int kQOff = kBOff + kBBufs * kBBufBytes;       // after the bf16 buffers
    constexpr int kBarOff = kQOff + kStages * kQStageBytes;  // full[kStages], empty[kStages]
    const uint32_t full = base + kBarOff, empty = full + kStages * 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int m0 = blockIdx.x * Shape::BM, n0 = blockIdx.y * kBN;
    const int KT = (K + kBK - 1) / kBK;
    // q by TMA where its rows are 16-byte aligned (every model shape), else
    // by 8-byte cp.asyncs, whose 32 lanes each arrive when theirs land
    const bool q_tma = N % 16 == 0;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + 8 * s, q_tma ? 1 : 1 + 32);
            mbar_init(empty + 8 * s, 4 * kWG);  // each consumer warp
        }
        fence_mbarrier_init();
    }
    __syncthreads();

    if (warp == 4 * kWG) {  // the producer warp
        for (int kt = 0; kt < KT; ++kt) {
            const int s = kt % kStages;
            mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
            const int k0 = kt * kBK;
            const uint32_t dst = base + kQOff + s * kQStageBytes;
            if (lane == 0) {
                mbar_arrive_expect_tx(full + 8 * s, Shape::kXBytes + (q_tma ? kQStageBytes : 0));
                tma_load_2d(base + s * Shape::kXBytes, &tmap_x, k0, m0, full + 8 * s);
                if (q_tma) tma_load_2d(dst, &tmap_q, n0, k0, full + 8 * s);
            }
            if (!q_tma) {
#pragma unroll 4
                for (int i = lane; i < kBK * kBN / 8; i += 32) {
                    const int k = i >> 4, c = (i & 15) * 8, gk = k0 + k, gn = n0 + c;
                    const bool in = gk < K && gn < N;
                    cp_async_8(dst + k * kBN + c, in ? q + static_cast<size_t>(gk) * N + gn : q,
                               in ? 8 : 0);
                }
                cp_async_arrive_noinc(full + 8 * s);
            }
        }
        cp_async_wait_all();
    } else {  // the consumer warpgroups
        const int wg = tid >> 7;
        float acc[64];  // the first products overwrite it (accumulate 0)
        for (int kt = 0; kt < KT; ++kt) {
            const int s = kt % kStages, b = kt % kBBufs;
            mbar_wait(full + 8 * s, (kt / kStages) & 1);
            // q's int8 tile -> bf16, exactly, at (k, n) of an MN-major
            // operand: atom (n / 64, k / 8) of 8 k-rows x 64 n, its 16-byte
            // chunk n % 64 / 8 swizzled by k % 8. Every read first, then
            // the conversions: the thread's chunks are independent
            const uint8_t* qsrc = smem + kQOff + s * kQStageBytes;
            uint8_t* bdst = smem + kBOff + b * kBBufBytes;
            uint2 w[Shape::kChunks];
#pragma unroll
            for (int j = 0; j < Shape::kChunks; ++j) {
                const int i = tid + j * Shape::kConsumers;
                w[j] = *reinterpret_cast<const uint2*>(qsrc + (i >> 4) * kBN + (i & 15) * 8);
            }
#pragma unroll
            for (int j = 0; j < Shape::kChunks; ++j) {
                const int i = tid + j * Shape::kConsumers;
                const int k = i >> 4, c16 = i & 15, r = k & 7;
                float f[8];
                int8x4_to_float(w[j].x, f);
                int8x4_to_float(w[j].y, f + 4);
                *reinterpret_cast<uint4*>(bdst + (c16 >> 3) * (8 * kAtom) + (k >> 3) * kAtom +
                                          r * 128 + (((c16 & 7) ^ r) << 4)) =
                    make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                               pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
            }
            fence_proxy_async();  // the converted tile, visible to wgmma
            named_bar_sync(1, Shape::kConsumers);
            // A: this warpgroup's 64 rows, K-major, 16 bf16 (32 bytes) a step
            // within the swizzled rows; B: two 8-deep atoms a step
            const uint32_t a0 = base + s * Shape::kXBytes + wg * 64 * 128;
            const uint32_t b0 = base + kBOff + b * kBBufBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
                wgmma_m64n128k16_bf16_bmn(acc, wgmma_desc_sw128(a0 + kk * 32, 16, kAtom),
                                          wgmma_desc_sw128(b0 + kk * 2 * kAtom, 8 * kAtom, kAtom),
                                          kt > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
            for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
            if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
        // the m64n128 fragment: warp w of the warpgroup holds rows 16 w + g
        // and 16 w + g + 8, columns 8 j + 2 t and + 1 of each 8-column block j
        const int g = lane >> 2, t = lane & 3;
        const int row = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col >= N) continue;  // N is even: col + 1 < N too
            const float s0 = scale[col], s1 = scale[col + 1];
            if (row < M)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
                    make_float2(acc[4 * j] * s0, acc[4 * j + 1] * s1);
            if (row + 8 < M)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
                    make_float2(acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
        }
    }
}

template <int kWG>
cudaError_t launch_wgmma(const void* x, const void* q, const void* s, void* out, int M, int K,
                         int N, cudaStream_t stream) {
    using Shape = TileShape<kWG>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        w8_wgmma_kernel<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (attr != cudaSuccess) return attr;
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint32_t steps[2] = {1, 1};
    CUtensorMap tmap_x, tmap_q;
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t x_stride[1] = {static_cast<cuuint64_t>(K) * 2};  // bytes, a multiple of 16
    const cuuint32_t x_box[2] = {kBK, Shape::BM};
    if (encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), x_dims,
               x_stride, x_box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    tmap_q = tmap_x;  // unread where N % 16 != 0: the kernel takes q by cp.async there
    const cuuint64_t q_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
    const cuuint64_t q_stride[1] = {static_cast<cuuint64_t>(N)};
    const cuuint32_t q_box[2] = {kBN, kBK};
    if (N % 16 == 0 &&
        encode(&tmap_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), q_dims, q_stride,
               q_box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
            CUDA_SUCCESS)
        return cudaErrorInvalidValue;
    // M tiles fastest: the blocks that share a weight tile run together
    const dim3 grid((M + Shape::BM - 1) / Shape::BM, (N + kBN - 1) / kBN);
    w8_wgmma_kernel<kWG><<<grid, Shape::kThreads, Shape::kSmem, stream>>>(
        tmap_x, tmap_q, static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
}

// The tile path: out (M, N) f32 = (x . q) * s, any M >= 1; K and N
// multiples of 8; x, q 16-byte aligned. Tiles of 64 rows up to M 64; above,
// of 256 rows where they take fewer waves than tiles of 128 (one block an
// SM for either), else of 128: a 256-row tile took 1.33-1.41x a 128-row one
// at the 7B wo shape (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py
// --tile-rows), so a wave fewer pays and an equal count does not.
inline cudaError_t launch_tile(const void* x, const void* q, const void* s, void* out, int M,
                               int K, int N, cudaStream_t stream) {
    if (M <= 64) return launch_wgmma<1>(x, q, s, out, M, K, N, stream);
    const int cols = (N + kBN - 1) / kBN, sms = hopper::num_sms();
    const int waves128 = ((M + 127) / 128 * cols + sms - 1) / sms;
    const int waves256 = ((M + 255) / 256 * cols + sms - 1) / sms;
    if (waves256 < waves128) return launch_wgmma<4>(x, q, s, out, M, K, N, stream);
    return launch_wgmma<2>(x, q, s, out, M, K, N, stream);
}

}  // namespace
}  // namespace w8
