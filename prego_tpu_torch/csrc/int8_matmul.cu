// K4 and K5: the int8 serving matmuls on Hopper.
//
// Replace prego_tpu/ops/quant.py::int8_matmul (quant.py:80, Pallas body
// _int8_matmul_kernel) and ::int8xint8_matmul (_int8xint8_matmul_kernel):
//   K4  y (M, N) f32 = (bf16(x) . bf16(q)) * s       x (M, K) bf16
//   K5  y (M, N) f32 = float(xq . q) * x_s * s       xq (M, K) int8, x_s (M,) f32
// with q (K, N) int8 stored row-major and s (N,) f32, one scale per output
// channel. K4's products of a bf16 and an int8 value are exact in f32 and
// summed in f32; K5 sums its int8 products exactly in int32 and rounds the
// sum once to f32, then multiplies by x_s and s in that order (the JAX
// order), so it matches its plain version to that rounding alone.
//
// What bounds them here: at decode (M = batch <= 8) each weight byte is
// used M times, so a projection streams its int8 weights once (the 7B
// decode step reads 6.7 GB of them, 2.0 ms at 3.35 TB/s), the work is to
// keep enough loads in flight, and the host's launches weigh as much. At
// prefill (M = B x S, up to thousands of rows) the products bound them, on
// the tensor cores.
//
// K4's design is in w8_matmul.cuh (shared with K9): at M <= 8 the
// streaming GEMV with its splits of K summed in a thread block cluster
// (one launch, no scratch); above, a pipelined wgmma kernel fed by TMA and
// cp.async, the int8 weights converted to bf16 in shared memory.
//
// K5 keeps its first design:
//   * M <= 8, weight streaming (GEMV) in K4's layout: a block owns 128
//     output columns and one split of K, reads 4 rows at once, transposes
//     the 4 x 4 byte blocks with byte permutes so that one register holds 4
//     consecutive k of a column, and uses __dp4a (4 int8 products into
//     int32). The 16 row groups of a block are summed with a shuffle and
//     through shared memory in a fixed order; splits of K go to a scratch
//     (S, M, N) that a second launch sums in split order and scales: no
//     atomics, the same bits every run.
//   * M > 8, tensor-core tiles: 64 x 128 output tiles, 4 warps of 32 x 64,
//     mma.sync m16n8k32 s8. The weight tile is read row-major with 8-byte
//     loads; the mma needs 4 consecutive k of a column in a register, and
//     ldmatrix.trans does not move 8-bit elements, so each thread
//     transposes 4 x 4 byte blocks with byte permutes and stores the tile
//     (n, k). One shared stage; the next stage's global loads are held in
//     registers while the current one's products run.
#include <stdint.h>

#include "common.cuh"
#include "w8_matmul.cuh"

namespace {

// K5's streaming path keeps K4's layout (w8_matmul.cuh)
constexpr int kMaxGemvM = w8::kMaxM;
constexpr int kGemvThreads = w8::kThreads;
constexpr int kGemvCols = w8::kCols;
constexpr int kColGroups = w8::kColGroups;
constexpr int kTileN = w8::kTileN;
constexpr int kRowGroups = w8::kRowGroups;
constexpr int kChunk = w8::kChunk;
using w8::split_rows;

// K5's tiles
constexpr int kTileThreads = 128;
constexpr int kBM = 64, kBN = 128;
constexpr int kBK8 = 64;  // int8 depth a stage

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

__device__ __forceinline__ unsigned int ld32(const void* p) {
    return *reinterpret_cast<const unsigned int*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned int* a, unsigned int b0,
                                       unsigned int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- K5, M <= 8: weight streaming ----

template <int M>
__global__ void __launch_bounds__(kGemvThreads) w8a8_gemv_kernel(
    const int8_t* __restrict__ xq,  // (M, K)
    const int8_t* __restrict__ q,   // (K, N)
    int* __restrict__ part,         // (S, M, N)
    int K, int N, int rows_per_split) {
    __shared__ int xs[kChunk / 4][M];  // 4 consecutive k of a row, packed
    __shared__ int red[kRowGroups / 2][M][kTileN];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = tid % kColGroups, rg = tid / kColGroups;
    const int n0 = blockIdx.x * kTileN, n = n0 + cg * kGemvCols;
    const int split = blockIdx.y;
    const int kb = split * rows_per_split, ke = min(K, kb + rows_per_split);
    int acc[M][kGemvCols];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < kGemvCols; ++j) acc[m][j] = 0;
    for (int c0 = kb; c0 < ke; c0 += kChunk) {
        const int quads = min(kChunk, ke - c0) / 4;  // K is a multiple of 16
        __syncthreads();
        for (int i = tid; i < M * quads; i += kGemvThreads) {
            const int m = i / quads, k4 = i % quads;
            xs[k4][m] = *reinterpret_cast<const int*>(xq + static_cast<size_t>(m) * K + c0 + 4 * k4);
        }
        __syncthreads();
        if (n < N) {
            const int8_t* qc = q + static_cast<size_t>(c0) * N + n;
#pragma unroll 2
            for (int k4 = rg; k4 < quads; k4 += kRowGroups) {
                const int8_t* r = qc + static_cast<size_t>(4 * k4) * N;
                const uint2 r0 = *reinterpret_cast<const uint2*>(r);
                const uint2 r1 = *reinterpret_cast<const uint2*>(r + N);
                const uint2 r2 = *reinterpret_cast<const uint2*>(r + 2 * static_cast<size_t>(N));
                const uint2 r3 = *reinterpret_cast<const uint2*>(r + 3 * static_cast<size_t>(N));
                unsigned int w[kGemvCols];
                transpose4x4(r0.x, r1.x, r2.x, r3.x, w);
                transpose4x4(r0.y, r1.y, r2.y, r3.y, w + 4);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const int xv = xs[k4][m];
#pragma unroll
                    for (int j = 0; j < kGemvCols; ++j)
                        acc[m][j] = __dp4a(xv, static_cast<int>(w[j]), acc[m][j]);
                }
            }
        }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < kGemvCols; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if (lane < 16) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < kGemvCols; ++j) red[warp][m][cg * kGemvCols + j] = acc[m][j];
    }
    __syncthreads();
    for (int i = tid; i < M * kTileN; i += kGemvThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        int y = 0;
#pragma unroll
        for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][m][c];
        part[(static_cast<size_t>(split) * M + m) * N + n0 + c] = y;
    }
}

// splits summed in order, then the scales
__global__ void __launch_bounds__(256) w8a8_reduce_kernel(
    const int* __restrict__ part, const float* __restrict__ x_scale,
    const float* __restrict__ scale, float* __restrict__ out, int MN, int N, int S) {
    const int i = blockIdx.x * 256 + threadIdx.x;
    if (i >= MN) return;
    int y = 0;
    for (int s = 0; s < S; ++s) y += part[static_cast<size_t>(s) * MN + i];
    out[i] = static_cast<float>(y) * x_scale[i / N] * scale[i % N];
}

// ---- K5, M > 8: tensor-core tiles ----

__global__ void __launch_bounds__(kTileThreads) w8a8_tile_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
    const int8_t* __restrict__ q, const float* __restrict__ scale, float* __restrict__ out,
    int M, int K, int N) {
    constexpr int LD = kBK8 + 16;  // 80-byte rows: the fragment loads of a warp hit 32 banks
    __shared__ __align__(16) int8_t As[kBM][LD];  // (m, k)
    __shared__ __align__(16) int8_t Bs[kBN][LD];  // (n, k): transposed, k contiguous
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
    const int kq = tid & 15, nc = (tid >> 4) * 16;  // this thread's 4 rows x 16 columns of q
    int acc[2][8][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

    uint4 xa[2];
    unsigned int wb[4][4];
    auto fetch = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * kTileThreads;
            const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 16;  // 64 rows x 4 runs of 16
            xa[i] = make_uint4(0u, 0u, 0u, 0u);
            if (gm < M && gk < K) xa[i] = *reinterpret_cast<const uint4*>(xq + static_cast<size_t>(gm) * K + gk);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) load_w16(q, k0 + 4 * kq + j, n0 + nc, K, N, wb[j]);
    };
    auto stage = [&]() {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int c = tid + i * kTileThreads;
            *reinterpret_cast<uint4*>(&As[c >> 2][(c & 3) * 16]) = xa[i];
        }
        // 4 x 4 byte blocks transposed in registers: one word holds the 4 k
        // of one column, stored at once
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            unsigned int col[4];
            transpose4x4(wb[0][i], wb[1][i], wb[2][i], wb[3][i], col);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<unsigned int*>(&Bs[nc + 4 * i + j][4 * kq]) = col[j];
        }
    };

    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kBK8) {
        __syncthreads();
        stage();
        __syncthreads();
        if (k0 + kBK8 < K) fetch(k0 + kBK8);
#pragma unroll
        for (int kk = 0; kk < kBK8; kk += 32) {
            unsigned int a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int row = wm + mt * 16 + g;
                a[mt][0] = ld32(&As[row][kk + 4 * t]);
                a[mt][1] = ld32(&As[row + 8][kk + 4 * t]);
                a[mt][2] = ld32(&As[row][kk + 16 + 4 * t]);
                a[mt][3] = ld32(&As[row + 8][kk + 16 + 4 * t]);
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int col = wn + nt * 8 + g;
                const unsigned int b0 = ld32(&Bs[col][kk + 4 * t]);
                const unsigned int b1 = ld32(&Bs[col][kk + 16 + 4 * t]);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int row = m0 + wm + mt * 16 + g, col = n0 + wn + nt * 8 + 2 * t;
            if (col >= N) continue;
            const float s0 = scale[col], s1 = scale[col + 1];
            if (row < M) {
                const float xs = x_scale[row];
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
                    make_float2(static_cast<float>(acc[mt][nt][0]) * xs * s0,
                                static_cast<float>(acc[mt][nt][1]) * xs * s1);
            }
            if (row + 8 < M) {
                const float xs = x_scale[row + 8];
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
                    make_float2(static_cast<float>(acc[mt][nt][2]) * xs * s0,
                                static_cast<float>(acc[mt][nt][3]) * xs * s1);
            }
        }
}

template <int M>
struct W8A8Gemv {
    static cudaError_t run(dim3 grid, cudaStream_t s, const void* xq, const void* q, void* part,
                           int K, int N, int rows) {
        w8a8_gemv_kernel<M><<<grid, kGemvThreads, 0, s>>>(
            static_cast<const int8_t*>(xq), static_cast<const int8_t*>(q),
            static_cast<int*>(part), K, N, rows);
        return cudaGetLastError();
    }
};

}  // namespace

// Splits of K for the streaming path (M <= 8); 0 selects the tile path.
// K4 sums its splits in a cluster, so takes at most w8::kMaxClusterSplits.
PREGO_EXPORT int prego_int8_matmul_splits(int M, int K, int N) {
    return M > kMaxGemvM ? 0 : w8::num_splits(K, N, w8::kMaxClusterSplits);
}

// K5's splits, summed by a second launch
PREGO_EXPORT int prego_int8xint8_matmul_splits(int M, int K, int N) {
    return M > kMaxGemvM ? 0 : w8::num_splits(K, N);
}

// K4: out (M, N) f32 = (x (M, K) bf16 . q (K, N) int8) * s (N,) f32, one
// launch. splits = prego_int8_matmul_splits (0: the tile path). K and N
// multiples of 8.
PREGO_EXPORT int prego_int8_matmul(const void* x, const void* q, const void* s, void* out, int M,
                                   int K, int N, int splits, void* stream) {
    if (M < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0 ||
        splits != prego_int8_matmul_splits(M, K, N))
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (splits == 0) return w8::launch_tile(x, q, s, out, M, K, N, st);
    return w8::launch_gemv_cluster(x, q, s, out, M, K, N, splits, st);
}

// K5: out (M, N) f32 = float(xq (M, K) int8 . q (K, N) int8) * x_scale (M,)
// * s (N,). part is int32 scratch (splits, M, N). K a multiple of 16, N of 8.
PREGO_EXPORT int prego_int8xint8_matmul(const void* xq, const void* x_scale, const void* q,
                                        const void* s, void* part, void* out, int M, int K,
                                        int N, int splits, void* stream) {
    if (M < 1 || K < 16 || N < 8 || K % 16 != 0 || N % 8 != 0 ||
        splits != prego_int8xint8_matmul_splits(M, K, N))
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (splits == 0) {
        w8a8_tile_kernel<<<dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM), kTileThreads, 0, st>>>(
            static_cast<const int8_t*>(xq), static_cast<const float*>(x_scale),
            static_cast<const int8_t*>(q), static_cast<const float*>(s), static_cast<float*>(out),
            M, K, N);
        return cudaGetLastError();
    }
    const dim3 grid((N + kTileN - 1) / kTileN, splits);
    cudaError_t err = w8::dispatch_m<W8A8Gemv>(M, grid, st, xq, q, part, K, N,
                                                    split_rows(K, splits));
    if (err != cudaSuccess) return err;
    w8a8_reduce_kernel<<<(M * N + 255) / 256, 256, 0, st>>>(
        static_cast<const int*>(part), static_cast<const float*>(x_scale),
        static_cast<const float*>(s), static_cast<float*>(out), M * N, N, splits);
    return cudaGetLastError();
}
