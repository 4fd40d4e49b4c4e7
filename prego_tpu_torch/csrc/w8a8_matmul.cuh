// K5's int8 x int8 product (int8_matmul.cu): y (M, N) f32 =
// f32(int32 xq (M, K) . q (K, N)) * x_scale (M,) * s (N,), in that order,
// with q (K, N) int8 row-major, the layout K4 and K9 share. Replaces
// prego_tpu/ops/quant.py:169 int8xint8_matmul (Pallas body
// _int8xint8_matmul_kernel). The int8 products and their int32 sums are
// exact, so every design and every order of the sums gives the same bits.
//
// M <= 8, the streaming GEMV (w8a8_gemv_kernel). Bound by bytes: a 7B
// decode step's five projections stream 0.33 GB of int8 weights at M 1
// (0.0997 ms at 3.35 TB/s). K4's layout: a block owns 128 output columns
// and one split of K, a thread 8 consecutive columns of a row (an 8-byte
// load); 4 rows at once are transposed in 4 x 4 byte blocks with byte
// permutes, so that one register holds 4 consecutive k of a column, and
// __dp4a takes 4 int8 products into int32. The 16 row groups of a block are
// summed with a shuffle and through shared memory. One launch: each split
// adds its (M, 128) int32 sums into a persistent workspace ws (M, N) with
// atomics, then takes a ticket on its column tile's counter (one acq_rel
// atomic by one thread after the block's barrier); the last split
// of a tile reads the totals back, zeroing them as it reads (atomicExch),
// applies the scales, writes out and zeroes the counter. So the workspace
// and the counters are zero between calls (a captured graph can replay the
// call), the caller allocates only out, and the bits do not depend on the
// order in which the splits arrive. One split writes out directly.
//
// M > 8, the tile path (w8a8_wgmma_kernel). Bound by operations (w13 at M
// 512: 92.3 G int8 operations, 0.0467 ms at 1,979 TOP/s), which only
// wgmma reaches. K4's machinery (w8_matmul.cuh): tiles of BM x 128 outputs,
// BM = 64 x the consumer warpgroups, chosen as K4 chooses them; a producer
// warp keeps a ring of stages in flight, each tracked by a full and an
// empty mbarrier: xq's tile (BM x 128 int8) by TMA with the 128-byte
// swizzle, a K-major A operand as it lies; q's tile (128 k x 128 n) by TMA
// as it lies where N is a multiple of 16 (every model shape), else by
// 8-byte cp.asyncs; zeros past the K, M and N edges. wgmma reads 8-bit B
// only K-major (the transpose bit is for 16-bit types), and q's tile is
// N-major, so the consumers first transpose it, together, into a K-major
// copy with the 128-byte swizzle in the same stage: a thread reads 16 rows
// of 4 columns with 4-byte loads (a warp reads whole 128-byte rows), forms
// each column's 16 k with byte permutes and stores them as one 16-byte
// chunk; the lanes take their 4 columns in rotated orders, so that the 8
// lanes of a quarter warp store to 8 distinct chunk columns of the swizzle
// and no store conflicts. Then fence.proxy.async and a named barrier over
// the consumers, and wgmma m64n128k32 s8 x s8 -> s32, A and B from shared
// memory, 4 a stage, committed as one group; each warpgroup waits for its
// previous group only (wgmma.wait_group 1) and then releases that stage,
// whose transposed copy lives as long as its loads. The epilogue converts
// s32 to f32 and multiplies by x_scale, then s, with 8-byte stores.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "w8_matmul.cuh"

namespace w8a8 {
// Internal linkage, as in w8_matmul.cuh
namespace {

// ---- M <= 8: the streaming GEMV ----

constexpr int kMaxM = w8::kMaxM;
constexpr int kThreads = w8::kThreads;
constexpr int kCols = w8::kCols;
constexpr int kColGroups = w8::kColGroups;
constexpr int kTileN = w8::kTileN;
constexpr int kRowGroups = w8::kRowGroups;
constexpr int kChunk = w8::kChunk;

// This block's (M, 128) int32 sums of xq . q over the split blockIdx.y's
// rows, into red (row groups of a warp joined, the warps still apart);
// the caller sums red's kRowGroups / 2 warps in order after a barrier.
template <int M>
__device__ __forceinline__ void gemv_partial(const int8_t* __restrict__ xq,
                                             const int8_t* __restrict__ q, int K, int N,
                                             int rows_per_split, int (*xs)[M],
                                             int (*red)[M][kTileN]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = tid % kColGroups, rg = tid / kColGroups;
    const int n = blockIdx.x * kTileN + cg * kCols;
    const int kb = blockIdx.y * rows_per_split, ke = min(K, kb + rows_per_split);
    int acc[M][kCols];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = 0;
    for (int c0 = kb; c0 < ke; c0 += kChunk) {
        const int quads = min(kChunk, ke - c0) / 4;  // K is a multiple of 16
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < M * quads; i += kThreads) {
            const int m = i / quads, k4 = i % quads;
            xs[k4][m] =
                *reinterpret_cast<const int*>(xq + static_cast<size_t>(m) * K + c0 + 4 * k4);
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
                unsigned int w[kCols];
                transpose4x4(r0.x, r1.x, r2.x, r3.x, w);
                transpose4x4(r0.y, r1.y, r2.y, r3.y, w + 4);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const int xv = xs[k4][m];
#pragma unroll
                    for (int j = 0; j < kCols; ++j)
                        acc[m][j] = __dp4a(xv, static_cast<int>(w[j]), acc[m][j]);
                }
            }
        }
    }
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
}

template <int M>
__global__ void __launch_bounds__(kThreads) w8a8_gemv_kernel(
    const int8_t* __restrict__ xq,        // (M, K)
    const float* __restrict__ x_scale,    // (M,)
    const int8_t* __restrict__ q,         // (K, N)
    const float* __restrict__ scale,      // (N,)
    float* __restrict__ out,              // (M, N)
    int* __restrict__ ws,                 // (M, N) int32, zero between calls
    unsigned int* __restrict__ tickets,   // (ceil(N / 128),), zero between calls
    int K, int N, int rows_per_split) {
    __shared__ int xs[kChunk / 4][M];  // 4 consecutive k of a row, packed
    __shared__ int red[kRowGroups / 2][M][kTileN];
    __shared__ bool last;
    gemv_partial<M>(xq, q, K, N, rows_per_split, xs, red);
    __syncthreads();
    const int tid = threadIdx.x, n0 = blockIdx.x * kTileN;
    const bool one_split = gridDim.y == 1;
    for (int i = tid; i < M * kTileN; i += kThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        int y = 0;
#pragma unroll
        for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][m][c];
        if (one_split)
            out[static_cast<size_t>(m) * N + n0 + c] =
                static_cast<float>(y) * x_scale[m] * scale[n0 + c];
        else
            atomicAdd(ws + static_cast<size_t>(m) * N + n0 + c, y);
    }
    if (one_split) return;
    __syncthreads();  // the block's sums before thread 0's release
    if (tid == 0) {  // one atomic that releases this block's sums and acquires the others'
        unsigned int prev;
        asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                     : "=r"(prev)
                     : "l"(tickets + blockIdx.x)
                     : "memory");
        last = prev == gridDim.y - 1;
    }
    __syncthreads();
    if (!last) return;
    for (int i = tid; i < M * kTileN; i += kThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        const int y = atomicExch(ws + static_cast<size_t>(m) * N + n0 + c, 0);
        out[static_cast<size_t>(m) * N + n0 + c] =
            static_cast<float>(y) * x_scale[m] * scale[n0 + c];
    }
    if (tid == 0) tickets[blockIdx.x] = 0u;
}

template <int M>
struct Gemv {
    static cudaError_t run(dim3 grid, cudaStream_t s, const void* xq, const void* x_scale,
                           const void* q, const void* scale, void* out, void* ws, void* tickets,
                           int K, int N, int rows) {
        w8a8_gemv_kernel<M><<<grid, kThreads, 0, s>>>(
            static_cast<const int8_t*>(xq), static_cast<const float*>(x_scale),
            static_cast<const int8_t*>(q), static_cast<const float*>(scale),
            static_cast<float*>(out), static_cast<int*>(ws), static_cast<unsigned int*>(tickets),
            K, N, rows);
        return cudaGetLastError();
    }
};

// The streaming path: out = f32(xq . q) * x_scale * s, 1 <= M <= 8, splits
// = w8::num_splits(K, N); ws (M, N) int32 and tickets (ceil(N / 128),)
// zero, and left zero.
inline cudaError_t launch_gemv(const void* xq, const void* x_scale, const void* q, const void* s,
                               void* out, void* ws, void* tickets, int M, int K, int N,
                               int splits, cudaStream_t stream) {
    const dim3 grid((N + kTileN - 1) / kTileN, splits);
    return w8::dispatch_m<Gemv>(M, grid, stream, xq, x_scale, q, s, out, ws, tickets, K, N,
                                w8::split_rows(K, splits));
}

// ---- M > 8: the wgmma tile path ----

constexpr int kBN = 128;                // output columns a tile
constexpr int kBK = 128;                // int8 depth a stage: one 128-byte row of xq
constexpr int kQBytes = kBK * kBN;      // q's tile as it lies: (k, n), rows of 128 bytes
constexpr int kBtBytes = kBN * kBK;     // its K-major copy: (n, k), 128-byte swizzle
constexpr int kAtom = 1024;             // 8 rows of 128 bytes: a swizzle atom
constexpr int kItems = kBK / 16 * kBN / 4;  // transpose items of 16 k x 4 n

template <int kWG>  // consumer warpgroups, 64 output rows each
struct TileShape {
    static constexpr int BM = 64 * kWG;
    static constexpr int kConsumers = 128 * kWG;
    static constexpr int kThreads = kConsumers + 32;  // and one producer warp
    // ring stages: 2 with one warpgroup, so that two blocks share an SM
    static constexpr int kStages = kWG == 1 ? 2 : kWG == 2 ? 4 : 3;
    static constexpr int kABytes = BM * kBK;
    static constexpr int kStageBytes = kABytes + kQBytes + kBtBytes;
    static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + kAtom;
};

// acc (64 s32 a thread, the m64n128 fragment) = A (64 x 32 s8) . B (32 x 128
// s8) + (accumulate ? acc : 0), both K-major in shared memory through their
// descriptors
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* acc, uint64_t da, uint64_t db,
                                                    int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n"
        "}\n"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
          "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
          "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
          "+r"(acc[16]), "+r"(acc[17]), "+r"(acc[18]), "+r"(acc[19]),
          "+r"(acc[20]), "+r"(acc[21]), "+r"(acc[22]), "+r"(acc[23]),
          "+r"(acc[24]), "+r"(acc[25]), "+r"(acc[26]), "+r"(acc[27]),
          "+r"(acc[28]), "+r"(acc[29]), "+r"(acc[30]), "+r"(acc[31]),
          "+r"(acc[32]), "+r"(acc[33]), "+r"(acc[34]), "+r"(acc[35]),
          "+r"(acc[36]), "+r"(acc[37]), "+r"(acc[38]), "+r"(acc[39]),
          "+r"(acc[40]), "+r"(acc[41]), "+r"(acc[42]), "+r"(acc[43]),
          "+r"(acc[44]), "+r"(acc[45]), "+r"(acc[46]), "+r"(acc[47]),
          "+r"(acc[48]), "+r"(acc[49]), "+r"(acc[50]), "+r"(acc[51]),
          "+r"(acc[52]), "+r"(acc[53]), "+r"(acc[54]), "+r"(acc[55]),
          "+r"(acc[56]), "+r"(acc[57]), "+r"(acc[58]), "+r"(acc[59]),
          "+r"(acc[60]), "+r"(acc[61]), "+r"(acc[62]), "+r"(acc[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

template <int kWG>
__global__ void __launch_bounds__(TileShape<kWG>::kThreads) w8a8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmap_x,  // xq (M, K) int8, boxes of BM x 128
    const __grid_constant__ CUtensorMap tmap_q,  // q (K, N) int8, boxes of 128 x 128; N % 16 == 0
    const int8_t* __restrict__ q, const float* __restrict__ x_scale,
    const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
    using Shape = TileShape<kWG>;
    using namespace hopper;
    constexpr int kStages = Shape::kStages;
    extern __shared__ uint8_t smem_raw[];
    // the swizzle atoms want 1024-byte alignment
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + kAtom - 1) & ~static_cast<uint32_t>(kAtom - 1);
    uint8_t* smem = smem_raw + (base - raw);
    // stage s: xq's tile, q's tile as it lies, q's K-major copy
    constexpr int kQOff = Shape::kABytes, kBtOff = kQOff + kQBytes;
    const uint32_t full = base + kStages * Shape::kStageBytes, empty = full + kStages * 8;
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
            const uint32_t stage = base + s * Shape::kStageBytes;
            if (lane == 0) {
                mbar_arrive_expect_tx(full + 8 * s, Shape::kABytes + (q_tma ? kQBytes : 0));
                tma_load_2d(stage, &tmap_x, k0, m0, full + 8 * s);
                if (q_tma) tma_load_2d(stage + kQOff, &tmap_q, n0, k0, full + 8 * s);
            }
            if (!q_tma) {
#pragma unroll 4
                for (int i = lane; i < kQBytes / 8; i += 32) {
                    const int k = i >> 4, c = (i & 15) * 8, gk = k0 + k, gn = n0 + c;
                    const bool in = gk < K && gn < N;
                    cp_async_8(stage + kQOff + k * kBN + c,
                               in ? q + static_cast<size_t>(gk) * N + gn : q, in ? 8 : 0);
                }
                cp_async_arrive_noinc(full + 8 * s);
            }
        }
        cp_async_wait_all();
    } else {  // the consumer warpgroups
        const int wg = tid >> 7;
        // this lane's order of its 4 columns: the 8 lanes of a quarter warp
        // store to 8 distinct chunk columns of the swizzle
        const int rot = (lane >> 1) & 3;
        int acc[64];  // the first products overwrite it (accumulate 0)
        for (int kt = 0; kt < KT; ++kt) {
            const int s = kt % kStages;
            mbar_wait(full + 8 * s, (kt / kStages) & 1);
            uint8_t* stage = smem + s * Shape::kStageBytes;
            // q's tile (k, n) -> its K-major copy: byte (n, k) at atom n / 8,
            // row n % 8, 16-byte chunk k / 16 swizzled by n % 8. Item (kb,
            // n4): rows 16 kb .. + 15 of columns 4 n4 .. + 3, lane = n4
            for (int it = tid; it < kItems; it += Shape::kConsumers) {
                const int kb = it >> 5;
                const uint8_t* src = stage + kQOff + kb * 16 * kBN + 4 * lane;
                unsigned int r[16];
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    r[i] = *reinterpret_cast<const unsigned int*>(src + i * kBN);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = (j + rot) & 3, n = 4 * lane + c;
                    const unsigned int sel = c | ((c + 4) << 4);  // byte c of two words
                    unsigned int w[4];  // w[g]: k = 16 kb + 4 g .. + 3 of column n
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        w[g] = __byte_perm(__byte_perm(r[4 * g], r[4 * g + 1], sel),
                                           __byte_perm(r[4 * g + 2], r[4 * g + 3], sel), 0x5410);
                    *reinterpret_cast<uint4*>(stage + kBtOff + (n >> 3) * kAtom + (n & 7) * 128 +
                                              ((kb ^ (n & 7)) << 4)) =
                        make_uint4(w[0], w[1], w[2], w[3]);
                }
            }
            fence_proxy_async();  // the K-major copy, visible to wgmma
            named_bar_sync(1, Shape::kConsumers);
            // A: this warpgroup's 64 rows; A and B step 32 k (bytes) within
            // their swizzled 128-byte rows
            const uint32_t a0 = base + s * Shape::kStageBytes + wg * 64 * kBK;
            const uint32_t b0 = base + s * Shape::kStageBytes + kBtOff;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 32; ++kk)
                wgmma_m64n128k32_s8(acc, wgmma_desc_sw128(a0 + kk * 32, 16, kAtom),
                                    wgmma_desc_sw128(b0 + kk * 32, 16, kAtom), kt > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
            for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
            if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
        // the m64n128 fragment: warp w of the warpgroup holds rows 16 w + g
        // and 16 w + g + 8, columns 8 j + 2 t and + 1 of each 8-column block j
        const int g = lane >> 2, t = lane & 3;
        const int row = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            if (col >= N) continue;  // N is even: col + 1 < N too
            const float s0 = scale[col], s1 = scale[col + 1];
            if (row < M) {
                const float xs = x_scale[row];
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) =
                    make_float2(static_cast<float>(acc[4 * j]) * xs * s0,
                                static_cast<float>(acc[4 * j + 1]) * xs * s1);
            }
            if (row + 8 < M) {
                const float xs = x_scale[row + 8];
                *reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8) * N + col) =
                    make_float2(static_cast<float>(acc[4 * j + 2]) * xs * s0,
                                static_cast<float>(acc[4 * j + 3]) * xs * s1);
            }
        }
    }
}

template <int kWG>
cudaError_t launch_wgmma(const void* xq, const void* x_scale, const void* q, const void* s,
                         void* out, int M, int K, int N, cudaStream_t stream) {
    using Shape = TileShape<kWG>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        w8a8_wgmma_kernel<kWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmem);
    if (attr != cudaSuccess) return attr;
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint32_t steps[2] = {1, 1};
    CUtensorMap tmap_x, tmap_q;
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t x_stride[1] = {static_cast<cuuint64_t>(K)};  // bytes, a multiple of 16
    const cuuint32_t x_box[2] = {kBK, Shape::BM};
    if (encode(&tmap_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(xq), x_dims, x_stride,
               x_box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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
    w8a8_wgmma_kernel<kWG><<<grid, Shape::kThreads, Shape::kSmem, stream>>>(
        tmap_x, tmap_q, static_cast<const int8_t*>(q), static_cast<const float*>(x_scale),
        static_cast<const float*>(s), static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
}

// The tile path, any M >= 1; K a multiple of 16, N of 8; xq, q 16-byte
// aligned. Row tiles as K4's (w8::launch_tile): 64 up to M 64; above, 256
// where they take fewer waves than 128, else 128.
inline cudaError_t launch_tile(const void* xq, const void* x_scale, const void* q, const void* s,
                               void* out, int M, int K, int N, cudaStream_t stream) {
    if (M <= 64) return launch_wgmma<1>(xq, x_scale, q, s, out, M, K, N, stream);
    const int cols = (N + kBN - 1) / kBN, sms = hopper::num_sms();
    const int waves128 = ((M + 127) / 128 * cols + sms - 1) / sms;
    const int waves256 = ((M + 255) / 256 * cols + sms - 1) / sms;
    if (waves256 < waves128) return launch_wgmma<4>(xq, x_scale, q, s, out, M, K, N, stream);
    return launch_wgmma<2>(xq, x_scale, q, s, out, M, K, N, stream);
}

}  // namespace
}  // namespace w8a8
