// K7q: the decode FFN sub-layer over int8 weights, on Hopper.
//
// Replaces prego_tpu/ops/fused_ffn.py::fused_ffn_block_q8 (Pallas body
// _fused_ffn_block_q8_kernel). For M <= 8 decode rows h (M, D) bf16:
//   xn  = bf16(bf16(h * rsqrt(mean(h^2) + eps)) * norm_w)
//   a   = bf16(silu((xn.W1q) s1) * ((xn.W3q) s3))      (f32 sums)
//   out = h + bf16((a.W2q) s2)
// with w13 = [W1q | W3q] (D, 2F) and w2 (F, D) int8, s13 (2F,) and s2 (D,)
// f32 column scales.
//
// What bounds it here: the weights' bytes. A call streams D x 3F int8 once
// (135.4 MB at D 4096, F 11008: 40.4 us at 3.35 TB/s) and does 6 M D F
// operations, far below the tensor cores' break-even; the work is to keep
// the card's memory busy from the first byte to the last. The first design
// (fused_ffn.cu, K7a's kernels over int8) made four launches with 4-byte
// loads a thread and streamed w2 only after the up phase had ended.
//
// Design: one persistent launch, one block on every SM (cooperative, so
// all are resident; its shared memory keeps a second block off an SM).
//   Work: block b owns up unit b, a column tile of 256 gate and 256 up
//     columns over one of P splits of D, and then down unit b, a tile of 512
//     output columns over one of S splits of F (P and S chosen so that each
//     phase has about one unit an SM).
//   Weights: TMA boxes of 32 rows x 128 int8 columns with the 128-byte
//     swizzle, four a stage (16 KB), through one ring of 4 stages guarded
//     by mbarriers that runs on from w13's stages into w2's: as the up
//     unit's last stages drain, the down unit's w2 streams in behind them,
//     while the block finishes its up unit and waits for the others (8
//     stages read 2% slower than 4, and 12 5% slower than 8: past what the
//     card needs in flight, more loads only contend). No producer warp:
//     thread 0 fills the ring, and the last of the eight warps to finish a
//     stage (a shared-memory count) refills it.
//   Products: mma.sync m16n8k16 bf16 with f32 sums, the weights as A (16
//     columns x 16 rows, transposed in the fragment load) and the
//     activations as B (16 rows x 8 decode rows, the rows past M zero), so
//     every row count costs the same. A warp owns 64 columns for the whole
//     split. Each int8 pair becomes a bf16x2 exactly in four instructions:
//     the low 7 bits under 2^7's exponent (128 + lo7), the sign bit under
//     -128's (-128 or -256), one bf16x2 add.
//   Up: thread 0 fills the ring first; meanwhile the block computes the
//     norm's statistic over all of h (rms_norm::inv_rms_rows) and its
//     split's normed rows (rms_norm::normed): bit for bit the norm launch.
//     Each split stores its f32 partial sums; once every split of its
//     column tile has (a barrier of the tile's blocks, all resident), each
//     adds the P partials of its share of the tile's columns in split order,
//     applies the scales and SiLU, writes that share of a (M, F) bf16 and
//     counts itself done.
//   Down: the block waits (one thread's relaxed loads) until all of a is
//     out, stages its rows of a, and streams its w2 split; after the tile's
//     barrier each split adds the S partials of its share of the columns in
//     split order, applies s2 and adds h.
// Sums in a fixed order and no float atomics: the same bits every call.
// Scratch (partials, a, counters) is the caller's persistent workspace; the
// counters are left zero.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "rms_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCols = 128;                  // int8 columns of a box: one swizzled row
constexpr int kBoxes = 4;                      // boxes a stage
constexpr int kTileCols = kBoxes * kBoxCols;   // columns a block owns, 64 a warp
constexpr int kRows = 32;                      // weight rows a stage
constexpr int kBoxBytes = kRows * kBoxCols;    // 4 KB
constexpr int kStageBytes = kBoxes * kBoxBytes;  // 16 KB
constexpr int kStages = 4;                     // 64 KB in flight a block
constexpr int kMaxM = 8;
constexpr int kPadK = 8;        // bf16 elements past each activation row
constexpr int kAlign = 1024;    // the swizzle's atom
static_assert(kRows == 32 && kRows % 16 == 0, "a stage is two k16 steps");
// a block's shared memory at the least: more than half an SM's 228 KB, so
// that no SM holds two blocks and the grid spreads over all
constexpr size_t kMinSmem = 116 * 1024;
static_assert(rms_norm::kThreads == kThreads, "the norm's statistic runs on the whole block");

// Shared memory of a block: the ring (1024-aligned), the activations
// [M][pitch] bf16 (xn, then a), the stages' full barriers and release counts
struct Smem {
    size_t act, bars, counts, bytes;
    __host__ __device__ Smem(int M, int pitch) {
        act = static_cast<size_t>(kStages) * kStageBytes;
        bars = act + ((sizeof(__nv_bfloat16) * M * pitch + 7) & ~size_t(7));
        counts = bars + 8 * kStages;
        bytes = kAlign + counts + 4 * kStages;
    }
};

// Part p's share [b, e) of n things (stages of kRows rows, a tile's
// columns) shared by `parts` blocks
__device__ __forceinline__ void share(int p, int parts, int n, int& b, int& e) {
    b = p * n / parts;
    e = (p + 1) * n / parts;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// int8 byte `byte` of lo and of hi -> bf16x2 (lo in the low half), exactly:
// each byte b = lo7 - 128 s becomes (128 + lo7) + (-128 - 128 s)
template <int byte>
__device__ __forceinline__ uint32_t int8_pair_bf16x2(uint32_t lo, uint32_t hi) {
    constexpr uint32_t sel = byte | (byte << 4) | ((4 + byte) << 8) | ((4 + byte) << 12);
    const uint32_t p = __byte_perm(lo, hi, sel);
    const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
    const uint32_t adj = (p & 0x00800080u) | 0xC300C300u;
    uint32_t r;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(mag), "r"(adj));
    return r;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage of a warp's 64 columns: box (the warp's 4 KB box, 32 swizzled
// rows of 128 bytes), col (0 or 64 within it), act_g (this lane's
// activation row g at the stage's first row, or null past M). acc[j][t]
// holds the m16n8 sums of columns 32 j + 4 g + 2 t (row i = g) and + 1 (i =
// g + 8) for decode rows 2 q and 2 q + 1.
__device__ __forceinline__ void stage_products(const uint8_t* box, int col,
                                               const __nv_bfloat16* act_g, int lane,
                                               float (*acc)[2][4]) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
        uint32_t b0 = 0, b1 = 0;
        if (act_g != nullptr) {
            b0 = *reinterpret_cast<const uint32_t*>(act_g + ks * 16 + 2 * q);
            b1 = *reinterpret_cast<const uint32_t*>(act_g + ks * 16 + 2 * q + 8);
        }
        uint32_t w[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int chunk = (col >> 4) + 2 * j + (g >> 2);
#pragma unroll
            for (int d = 0; d < 4; ++d) {  // rows 2q, 2q + 1, 2q + 8, 2q + 9
                const int r = ks * 16 + 2 * q + (d & 1) + 8 * (d >> 1);
                w[j][d] = lds32(box + r * kBoxCols + ((chunk ^ (r & 7)) << 4) + 4 * (g & 3));
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            uint32_t a[4];
            a[0] = int8_pair_bf16x2<0>(w[j][0], w[j][1]);
            a[1] = int8_pair_bf16x2<1>(w[j][0], w[j][1]);
            a[2] = int8_pair_bf16x2<0>(w[j][2], w[j][3]);
            a[3] = int8_pair_bf16x2<1>(w[j][2], w[j][3]);
            mma_bf16(acc[j][0], a, b0, b1);
            a[0] = int8_pair_bf16x2<2>(w[j][0], w[j][1]);
            a[1] = int8_pair_bf16x2<3>(w[j][0], w[j][1]);
            a[2] = int8_pair_bf16x2<2>(w[j][2], w[j][3]);
            a[3] = int8_pair_bf16x2<3>(w[j][2], w[j][3]);
            mma_bf16(acc[j][1], a, b0, b1);
        }
    }
}

// The ring of one block: stages of kBoxes TMA boxes; chunk i < n13 is row
// stage i of the up unit (w13), then chunk n13 + j is row stage j of the down
// unit (w2); box b of a stage comes from column col13[b] or col2[b]
struct Ring {
    uint8_t* stages;
    uint32_t full;       // shared address of full[kStages]
    int* counts;         // warps done with each stage
    const CUtensorMap *map13, *map2;
    int col13[kBoxes], col2[kBoxes];
    int row13, n13, row2, n2;

    __device__ void issue(int i) const {
        const int s = i % kStages;
        hopper::mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        const uint32_t dst = hopper::smem_u32(stages + s * kStageBytes);
        const bool up = i < n13;
        const int row = up ? row13 + i * kRows : row2 + (i - n13) * kRows;
#pragma unroll
        for (int b = 0; b < kBoxes; ++b)
            hopper::tma_load_2d(dst + b * kBoxBytes, up ? map13 : map2, up ? col13[b] : col2[b],
                                row, full + 8 * s);
    }

    // thread 0: the barriers, then the first stages' loads
    __device__ void start() const {
        for (int s = 0; s < kStages; ++s) {
            hopper::mbar_init(full + 8 * s, 1);
            counts[s] = 0;
        }
        hopper::fence_mbarrier_init();
        for (int i = 0; i < n13 + n2 && i < kStages; ++i) issue(i);
    }

    __device__ const uint8_t* wait(int i) const {
        const int s = i % kStages;
        hopper::mbar_wait(full + 8 * s, (i / kStages) & 1);
        return stages + s * kStageBytes;
    }

    // a warp is done with stage i: the last of the block's warps refills it
    __device__ void release(int i, int lane) const {
        __syncwarp();
        if (lane == 0) {
            const int s = i % kStages;
            __threadfence_block();
            if (atomicAdd(counts + s, 1) == kWarps - 1) {
                counts[s] = 0;
                __threadfence_block();
                hopper::fence_proxy_async();
                if (i + kStages < n13 + n2) issue(i + kStages);
            }
        }
    }
};

// The warp's products over chunks [begin, end) of the ring: its box and
// column within each stage, act_g its lane's activation row (or null)
__device__ __forceinline__ void stream_chunks(const Ring& ring, int begin, int end, int warp,
                                              int lane, const __nv_bfloat16* act_g,
                                              float (*acc)[2][4]) {
    const int box = warp >> 1, col = (warp & 1) * 64;
    for (int i = begin; i < end; ++i) {
        const uint8_t* stage = ring.wait(i);
        stage_products(stage + box * kBoxBytes, col,
                       act_g ? act_g + (i - begin) * kRows : nullptr, lane, acc);
        ring.release(i, lane);
    }
}

// The warp's sums for decode rows 2 q and 2 q + 1 (< M) at columns
// base + 32 j + 4 g + 2 t and + 1, to part (rows of `ld` floats), masked at
// `limit` (the column count is even, so the pair's second is inside too)
template <int M>
__device__ __forceinline__ void store_partials(float* part, size_t ld, int base, int limit,
                                               int lane, float (*acc)[2][4]) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            const int c = base + 32 * j + 4 * g + 2 * t;
            if (c >= limit) continue;
            if (2 * q < M)
                *reinterpret_cast<float2*>(part + (2 * q) * ld + c) =
                    make_float2(acc[j][t][0], acc[j][t][2]);
            if (2 * q + 1 < M)
                *reinterpret_cast<float2*>(part + (2 * q + 1) * ld + c) =
                    make_float2(acc[j][t][1], acc[j][t][3]);
        }
}

// until `count` is at least `want` (one thread, relaxed loads, one fence
// after: what was released before the count's adds is then visible)
__device__ __forceinline__ void wait_count(const unsigned int* count, unsigned int want) {
    unsigned int seen;
    do {
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < want);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// After every thread has stored its partials: until every one of the
// `splits` blocks of this column tile has (all are resident), so that each
// may sum its share of the tile's columns over the splits
__device__ __forceinline__ void tile_barrier(unsigned int* arrived, int splits) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(arrived, 1u);
        wait_count(arrived, splits);
    }
    __syncthreads();
}

// After a block's share is summed: the last of the tile's blocks to leave
// sets its two counts to zero again
__device__ __forceinline__ void tile_leave(unsigned int* arrived, int splits) {
    if (threadIdx.x == 0 && atomicAdd(arrived + 1, 1u) == static_cast<unsigned int>(splits) - 1) {
        arrived[0] = 0;
        arrived[1] = 0;
    }
}

// The workspace's counters: each column tile's arrivals and departures at
// its barrier, the up units whose share of a is out, and the blocks past
// their wait for all of a
struct Counters {
    unsigned int* tile13;  // [tiles13][2]
    unsigned int* tile2;   // [tiles2][2]
    unsigned int* done13;
    unsigned int* passed;
};

template <int M>
__global__ void __launch_bounds__(kThreads, 1) ffn_q8_kernel(
    const __grid_constant__ CUtensorMap map13,  // w13 (D, 2F) int8, boxes of 32 x 128
    const __grid_constant__ CUtensorMap map2,   // w2 (F, D) int8, boxes of 32 x 128
    const __nv_bfloat16* __restrict__ h,        // (M, D)
    const __nv_bfloat16* __restrict__ norm_w,   // (D,)
    const float* __restrict__ s13,              // (2F,)
    const float* __restrict__ s2,               // (D,)
    float* __restrict__ part13,                 // (P, M, 2F) partial sums
    __nv_bfloat16* a,                           // (M, F), written by the up units
    float* __restrict__ part2,                  // (S, M, D) partial sums
    Counters cnt,                               // zero, and left zero
    __nv_bfloat16* __restrict__ out,            // (M, D)
    int D, int F, int P, int S, int pitch, float eps) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float warp_part[M][rms_norm::kWarps];
    __shared__ float inv_rms[M];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    uint8_t* smem = smem_raw + (((raw + kAlign - 1) & ~uint32_t(kAlign - 1)) - raw);
    const Smem L(M, pitch);
    __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + L.act);  // [M][pitch]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
    const int tiles13 = (F + kTileCols / 2 - 1) / (kTileCols / 2);
    const int tiles2 = (D + kTileCols - 1) / kTileCols;
    const int b = blockIdx.x;
    const bool has13 = b < tiles13 * P, has2 = b < tiles2 * S;
    const int tile13 = b / P, p = b % P, f0 = tile13 * (kTileCols / 2);
    const int tile2 = b / S, s = b % S, n0 = tile2 * kTileCols;
    int c13 = 0, e13 = 0, c2 = 0, e2 = 0;
    if (has13) share(p, P, (D + kRows - 1) / kRows, c13, e13);  // the last may pass D: TMA zeros
    if (has2) share(s, S, (F + kRows - 1) / kRows, c2, e2);

    const Ring ring{smem, hopper::smem_u32(smem + L.bars), reinterpret_cast<int*>(smem + L.counts),
                    &map13, &map2,
                    {f0, f0 + kBoxCols, F + f0, F + f0 + kBoxCols},
                    {n0, n0 + kBoxCols, n0 + 2 * kBoxCols, n0 + 3 * kBoxCols},
                    c13 * kRows, e13 - c13, c2 * kRows, e2 - c2};
    if (tid == 0) ring.start();
    float acc[2][2][4];

    if (has13) {
        // xn for this split's rows, bit for bit with rms_norm's launch: 8
        // columns of every row a thread, staged in registers; zeros past
        // the split and past D, where TMA gives zero weights
        rms_norm::inv_rms_rows<M>(h, D, eps, warp_part, inv_rms);
        const int k0 = c13 * kRows, rows = min(D, e13 * kRows) - k0;  // a multiple of 16
        for (int k = tid * 8; k < pitch; k += kThreads * 8) {
            __nv_bfloat16 hv[M * 8], nv[8];
            if (k < rows) {
                *reinterpret_cast<uint4*>(nv) = *reinterpret_cast<const uint4*>(norm_w + k0 + k);
#pragma unroll
                for (int m = 0; m < M; ++m)
                    *reinterpret_cast<uint4*>(hv + 8 * m) =
                        *reinterpret_cast<const uint4*>(h + static_cast<size_t>(m) * D + k0 + k);
            }
#pragma unroll
            for (int m = 0; m < M; ++m) {
                __align__(16) __nv_bfloat16 v[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    v[j] = f2bf(k < rows ? rms_norm::normed(hv, nv, inv_rms[m], m, j, 8) : 0.f);
                *reinterpret_cast<uint4*>(act + m * pitch + k) = *reinterpret_cast<uint4*>(v);
            }
        }
        __syncthreads();

        for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0.f;
        stream_chunks(ring, 0, ring.n13, warp, lane, g < M ? act + g * pitch : nullptr, acc);
        // warps 0-3 hold gate columns f0 + 64 w ..., warps 4-7 the up columns
        store_partials<M>(part13 + static_cast<size_t>(p) * M * 2 * F + (warp < 4 ? 0 : F), 2 * F,
                          f0 + 64 * (warp & 3), F, lane, acc);
        tile_barrier(cnt.tile13 + 2 * tile13, P);
        int f_beg, f_end;
        share(p, P, kTileCols / 2, f_beg, f_end);
        for (int i = tid; i < M * (f_end - f_beg); i += kThreads) {
            const int m = i / (f_end - f_beg), f = f0 + f_beg + i % (f_end - f_beg);
            if (f >= F) continue;
            float gs = 0.f, us = 0.f;
            for (int j = 0; j < P; ++j) {
                const float* pj = part13 + (static_cast<size_t>(j) * M + m) * 2 * F;
                gs += __ldcg(pj + f);
                us += __ldcg(pj + F + f);
            }
            gs *= s13[f];
            us *= s13[F + f];
            const float silu = gs / (1.f + expf(-gs));
            a[static_cast<size_t>(m) * F + f] = f2bf(silu * us);
        }
        tile_leave(cnt.tile13 + 2 * tile13, P);
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            atomicAdd(cnt.done13, 1u);  // this unit's share of a is out
        }
    }
    if (!has2) return;

    // every tile of a, then this split's rows of it, 8 values a load (F and
    // the split's first row are multiples of 8), zeros past the split
    if (tid == 0) {
        wait_count(cnt.done13, tiles13 * P);
        // the last block past the wait leaves both counts zero
        if (atomicAdd(cnt.passed, 1u) == static_cast<unsigned int>(tiles2 * S) - 1) {
            *cnt.done13 = 0;
            *cnt.passed = 0;
        }
    }
    __syncthreads();
    const int k0 = c2 * kRows, rows = min(F, e2 * kRows) - k0;
    for (int i = tid; i < M * pitch / 8; i += kThreads) {
        const int m = i / (pitch / 8), k = (i % (pitch / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < rows)
            v = __ldcg(reinterpret_cast<const uint4*>(a + static_cast<size_t>(m) * F + k0 + k));
        reinterpret_cast<uint4*>(act)[i] = v;
    }
    __syncthreads();

    for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0.f;
    stream_chunks(ring, ring.n13, ring.n13 + ring.n2, warp, lane,
                  g < M ? act + g * pitch : nullptr, acc);
    store_partials<M>(part2 + static_cast<size_t>(s) * M * D, D, n0 + 64 * warp, D, lane, acc);
    tile_barrier(cnt.tile2 + 2 * tile2, S);
    int n_beg, n_end;
    share(s, S, kTileCols, n_beg, n_end);
    const int width = n_end - n_beg;
    for (int i = tid; i < M * width; i += kThreads) {
        const int m = i / width, n = n0 + n_beg + i % width;
        if (n >= D) continue;
        float y = 0.f;
#pragma unroll 16
        for (int j = 0; j < S; ++j) y += __ldcg(part2 + (static_cast<size_t>(j) * M + m) * D + n);
        y *= s2[n];
        const size_t o = static_cast<size_t>(m) * D + n;
        out[o] = f2bf(bf2f(h[o]) + round_bf16(y));
    }
    tile_leave(cnt.tile2 + 2 * tile2, S);
}

// cuTensorMapEncodeTiled from the driver, found through the runtime: no
// link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// an int8 (rows, cols) row-major matrix in boxes of kRows x kBoxCols, the
// 128-byte swizzle, zeros past its edges; cols a multiple of 16
cudaError_t weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols)};
    const cuuint32_t box[2] = {kBoxCols, kRows};
    const cuuint32_t steps[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, stride, box,
                  steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                   CUDA_SUCCESS
               ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
    const void *h, *norm_w, *w13, *s13, *w2, *s2;
    void *part13, *a, *part2, *counters, *out;
    int D, F, P, S;
    float eps;
};

// the dynamic shared memory the kernel may have: the card's opt-in limit
// less its static shared memory, allowed once; negative if that failed
template <typename Kernel>
int allow_smem(Kernel kernel) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&fa, kernel) != cudaSuccess)
        return -1;
    const int bytes = optin - static_cast<int>(fa.sharedSizeBytes);
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
                   cudaSuccess
               ? bytes : -1;
}

template <int M>
int launch(const Args& x, cudaStream_t stream) {
    static const int smem_max = allow_smem(ffn_q8_kernel<M>);
    if (smem_max < 0) return cudaErrorInvalidDeviceFunction;
    const int chunks13 = (x.D + kRows - 1) / kRows, chunks2 = (x.F + kRows - 1) / kRows;
    const int rows13 = (chunks13 + x.P - 1) / x.P * kRows, rows2 = (chunks2 + x.S - 1) / x.S * kRows;
    const int pitch = (rows13 > rows2 ? rows13 : rows2) + kPadK;
    const size_t smem = Smem(M, pitch).bytes > kMinSmem ? Smem(M, pitch).bytes : kMinSmem;
    if (smem > static_cast<size_t>(smem_max)) return PREGO_BAD_ARGUMENT;
    const int tiles13 = (x.F + kTileCols / 2 - 1) / (kTileCols / 2);
    const int tiles2 = (x.D + kTileCols - 1) / kTileCols;
    const int blocks = tiles13 * x.P > tiles2 * x.S ? tiles13 * x.P : tiles2 * x.S;
    if (blocks > hopper::num_sms()) return PREGO_BAD_ARGUMENT;
    CUtensorMap map13, map2;
    cudaError_t err;
    if ((err = weight_map(&map13, x.w13, x.D, 2 * x.F)) != cudaSuccess) return err;
    if ((err = weight_map(&map2, x.w2, x.F, x.D)) != cudaSuccess) return err;
    unsigned int* c = static_cast<unsigned int*>(x.counters);
    Counters cnt{c, c + 2 * tiles13, c + 2 * (tiles13 + tiles2), c + 2 * (tiles13 + tiles2) + 1};
    const __nv_bfloat16* h = static_cast<const __nv_bfloat16*>(x.h);
    const __nv_bfloat16* nw = static_cast<const __nv_bfloat16*>(x.norm_w);
    const float* s13 = static_cast<const float*>(x.s13);
    const float* s2 = static_cast<const float*>(x.s2);
    float* part13 = static_cast<float*>(x.part13);
    __nv_bfloat16* a = static_cast<__nv_bfloat16*>(x.a);
    float* part2 = static_cast<float*>(x.part2);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(x.out);
    int D = x.D, F = x.F, P = x.P, S = x.S, pitch_ = pitch;
    float eps = x.eps;
    void* args[] = {&map13, &map2, &h, &nw, &s13, &s2, &part13, &a, &part2, &cnt, &out,
                    &D, &F, &P, &S, &pitch_, &eps};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ffn_q8_kernel<M>),
                                      dim3(blocks), dim3(kThreads), args, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K7q: out (M, D) bf16 = h + FFN(rms_norm(h)) for h (M, D) and norm_w (D,)
// bf16, w13 (D, 2F) and w2 (F, D) int8 with f32 column scales s13 (2F,) and
// s2 (D,). 1 <= M <= 8; D and F multiples of 16 (TMA starts a box at a
// 16-byte boundary: the up columns begin at column F). P splits of D and S
// of F, at most one unit a block and one block an SM. Workspace: part13 (P,
// M, 2F) and part2 (S, M, D) f32, a (M, F) bf16, and counters (2 ceil(F /
// 256) + 2 ceil(D / 512) + 2) int32, zero, which the call leaves zero.
PREGO_EXPORT int prego_fused_ffn_block_q8(const void* h, const void* norm_w, const void* w13,
                                          const void* s13, const void* w2, const void* s2,
                                          void* part13, void* a, void* part2, void* counters,
                                          void* out, int M, int D, int F, int P, int S, float eps,
                                          void* stream) {
    if (M < 1 || M > kMaxM || D <= 0 || F <= 0 || D % 16 != 0 || F % 16 != 0 || P < 1 ||
        S < 1 || P > (D + kRows - 1) / kRows || S > (F + kRows - 1) / kRows)
        return PREGO_BAD_ARGUMENT;
    const Args x{h, norm_w, w13, s13, w2, s2, part13, a, part2, counters, out, D, F, P, S, eps};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (M) {
        case 1: return launch<1>(x, st);
        case 2: return launch<2>(x, st);
        case 3: return launch<3>(x, st);
        case 4: return launch<4>(x, st);
        case 5: return launch<5>(x, st);
        case 6: return launch<6>(x, st);
        case 7: return launch<7>(x, st);
        default: return launch<8>(x, st);
    }
}
