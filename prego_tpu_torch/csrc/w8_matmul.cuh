// K4's two int8-weight products (int8_matmul.cu), shared with K9
// (fused_dense_q8.cu): y (M, N) = bf16(x) (M, K) . q (K, N) int8.
//
// M <= 8, the streaming GEMV (w8_gemv_kernel): a block owns 128 output columns and one split of K; each thread reads 8
// consecutive int8 columns of a row (an 8-byte load; a warp reads two
// 128-byte row segments) for M rows of x staged in shared memory 256 rows
// at a time, converts the bytes to f32 exactly (common.cuh) and uses f32
// FMAs. The 16 row groups of a block are summed with a shuffle and through
// shared memory in a fixed order; each split writes its partial sums to a
// scratch (S, M, N) that the caller's second launch sums in split order:
// no atomics, the same bits every run. Splits are chosen so that about 4
// blocks run per SM.
//
// M > 8, tensor-core tiles (w8_tile_kernel): 64 x 128 output tiles, 4
// warps of 32 x 64, mma.sync m16n8k16 bf16. The weight tile is read
// row-major with 8-byte loads, converted to bf16 exactly and kept (k, n)
// in shared memory, where ldmatrix.trans hands the mma its B operand; one
// shared stage, the next stage's global loads held in registers while the
// current one's products run. The column scale is applied in the epilogue.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace w8 {

constexpr int kMaxM = 8;
constexpr int kThreads = 256;
constexpr int kCols = 8;                          // columns a thread, one 8-byte load
constexpr int kColGroups = 16;
constexpr int kTileN = kColGroups * kCols;        // 128 columns a block
constexpr int kRowGroups = kThreads / kColGroups;  // 16
constexpr int kChunk = 256;                       // rows of x staged at a time
constexpr int kSplitAlign = 64;                   // a split's rows: a multiple of this
constexpr int kTargetBlocks = 4 * 132;            // about 4 blocks per SM

inline int split_rows(int K, int splits) {
    const int rows = (K + splits - 1) / splits;
    return (rows + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
}

inline int num_splits(int K, int N) {
    const int tiles = (N + kTileN - 1) / kTileN;
    int s = (kTargetBlocks + tiles - 1) / tiles;
    const int max_s = K / 256 > 1 ? K / 256 : 1;
    s = s < max_s ? s : max_s;
    const int rows = split_rows(K, s);
    return (K + rows - 1) / rows;
}

// part[split] (M, N) = x (M, K) bf16 . q (K, N) int8 over the split's rows,
// f32, unscaled
template <int M>
__global__ void __launch_bounds__(kThreads) w8_gemv_kernel(
    const __nv_bfloat16* __restrict__ x,  // (M, K)
    const int8_t* __restrict__ q,          // (K, N)
    float* __restrict__ part,              // (S, M, N)
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
    for (int i = tid; i < M * kTileN; i += kThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        float y = 0.f;
#pragma unroll
        for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][m][c];
        part[(static_cast<size_t>(split) * M + m) * N + n0 + c] = y;
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
        w8_gemv_kernel<M><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
            static_cast<float*>(part), K, N, rows);
        return cudaGetLastError();
    }
};

// The streaming path's first launch: part (splits, M, N) f32, unscaled, for
// x (M, K) bf16 and q (K, N) int8, splits = num_splits(K, N); K and N
// multiples of 8, 1 <= M <= 8.
inline cudaError_t launch_gemv(const void* x, const void* q, void* part, int M, int K, int N,
                               int splits, cudaStream_t stream) {
    const dim3 grid((N + kTileN - 1) / kTileN, splits);
    return dispatch_m<Gemv>(M, grid, stream, x, q, part, K, N, split_rows(K, splits));
}

// ---- M > 8: tensor-core tiles ----

constexpr int kTileThreads = 128;
constexpr int kBM = 64, kBN = 128;
constexpr int kBK16 = 32;  // bf16 depth a stage

// q[gk, gn .. gn + 15] as 4 words, zero past the edges. A row of q starts
// 8-byte aligned only (N a multiple of 8, 1000 for one), so two 8-byte loads.
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ q, int gk, int gn, int K,
                                         int N, unsigned int* w) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        uint2 raw = make_uint2(0u, 0u);
        if (gk < K && gn + 8 * h < N)
            raw = *reinterpret_cast<const uint2*>(q + static_cast<size_t>(gk) * N + gn + 8 * h);
        w[2 * h] = raw.x;
        w[2 * h + 1] = raw.y;
    }
}

// two floats -> packed bf16 pair, the first in the low half
__device__ __forceinline__ unsigned int pack_bf16x2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<unsigned int*>(&v);
}

// four 8 x 8 b16 tiles from shared memory; lanes 8j .. 8j + 7 give tile j's rows
__device__ __forceinline__ void ldmatrix_x4(unsigned int* r, const void* p) {
    const unsigned int a = static_cast<unsigned int>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// the same, each tile transposed
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned int* r, const void* p) {
    const unsigned int a = static_cast<unsigned int>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned int* a, unsigned int b0,
                                         unsigned int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kTileThreads) w8_tile_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
    __shared__ __align__(16) __nv_bfloat16 As[kBM][kBK16 + 8];  // (m, k), 80-byte rows
    __shared__ __align__(16) __nv_bfloat16 Bs[kBK16][kBN + 8];  // (k, n), 272-byte rows
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
    float acc[2][8][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

    // the next stage in registers: 2 x 8 bf16 of x and 2 x 16 int8 of q a thread
    uint4 xa[2];
    unsigned int wb[2][4];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * kTileThreads;
            const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 8;  // 64 rows x 4 runs of 8
            xa[i] = make_uint4(0u, 0u, 0u, 0u);
            if (gm < M && gk < K) xa[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gm) * K + gk);
            load_w16(q, k0 + (c >> 3), n0 + (c & 7) * 16, K, N, wb[i]);  // 32 rows x 8 runs of 16
        }
    };
    auto stage = [&]() {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * kTileThreads;
            *reinterpret_cast<uint4*>(&As[c >> 2][(c & 3) * 8]) = xa[i];
            unsigned int h[8];  // the 16 weights as bf16 pairs, exactly
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float f[4];
                int8x4_to_float(wb[i][j], f);
                h[2 * j] = pack_bf16x2(f[0], f[1]);
                h[2 * j + 1] = pack_bf16x2(f[2], f[3]);
            }
            __nv_bfloat16* dst = &Bs[c >> 3][(c & 7) * 16];
            *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
            *reinterpret_cast<uint4*>(dst + 8) = make_uint4(h[4], h[5], h[6], h[7]);
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kBK16) {
        __syncthreads();  // the previous stage's readers are done
        stage();
        __syncthreads();
        if (k0 + kBK16 < K) fetch(k0 + kBK16);  // in flight during the products below
#pragma unroll
        for (int kk = 0; kk < kBK16; kk += 16) {
            unsigned int a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(a[mt], &As[wm + mt * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
            for (int np = 0; np < 4; ++np) {  // two n-tiles of 8 a load
                unsigned int b[4];
                ldmatrix_x4_trans(b, &Bs[kk + (lane & 15)][wn + np * 16 + (lane >> 4) * 8]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
                    mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                }
            }
        }
    }
    const int g = lane >> 2, t = lane & 3;  // mma fragment: row group, thread in group
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int row = m0 + wm + mt * 16 + g, col = n0 + wn + nt * 8 + 2 * t;
            if (col >= N) continue;  // N is even: col + 1 < N too
            const float s0 = scale[col], s1 = scale[col + 1];
            if (row < M)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
                    make_float2(acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
            if (row + 8 < M)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
                    make_float2(acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
        }
}

// The tile path: out (M, N) f32 = (x . q) * s, any M >= 1; K and N
// multiples of 8.
inline cudaError_t launch_tile(const void* x, const void* q, const void* s, void* out, int M,
                               int K, int N, cudaStream_t stream) {
    w8_tile_kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kTileThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
}

}  // namespace w8
