// K7 and K7a: the decode FFN over bf16 weights, on one TMA ring, on Hopper.
//
// K7 replaces prego_tpu/ops/fused_ffn.py::fused_ffn (Pallas body
// _fused_ffn_kernel). For M normed decode rows x (M, D) bf16:
//   a   = bf16(silu(x.W1) * (x.W3))                    (f32 sums)
//   out = a.W2                                          (f32, the caller casts)
// K7a replaces ::fused_ffn_block (Pallas body _fused_ffn_block_kernel), the
// sub-layer around it, for M decode rows h (M, D) bf16:
//   xn  = bf16(bf16(h * rsqrt(mean(h^2) + eps)) * norm_w)  (f32 statistic)
//   a   = bf16(silu(xn.W1) * (xn.W3))                  (f32 sums)
//   out = h + bf16(a.W2)                                (the residual in bf16)
// with w13 = [W1 | W3] (D, 2F) and w2 (F, D) bf16, 1 <= M <= 32 rows a
// launch. Shapes this ring takes (D and F multiples of 16, `ring_splits` in
// ops/fused_ffn.py) come here; the others take the first design, K7a's
// kernels in fused_ffn.cu, 8 rows a launch.
//
// What bounds it here: the weights' bytes. A call streams D x 3F bf16 once
// (69.2 MB at D 2048, F 5632: 20.7 us at 3.35 TB/s; 352.3 MB at Mistral-7B's
// D 4096, F 14336: 105 us) for 6 M D F operations: at M 32, 32 operations a
// byte, far below the tensor cores' ~295; the work is to keep the card's
// memory busy from the first byte to the last, and to read the weights once
// for every decode row of a step. The first design made four launches of
// f32 FMA GEMVs, 8 rows each, and streamed w2 only after the up phase had
// ended.
//
// Design: K7q's (fused_ffn_q8.cu) over bf16 weights, for up to four n8
// tiles of decode rows. One persistent launch, one block on every SM
// (cooperative, so all are resident; its shared memory keeps a second
// block off an SM).
//   Work: block b owns up unit b, a column tile of 256 gate and 256 up
//     columns over one of P splits of D, and then down unit b, a tile of 512
//     output columns over one of S splits of F (P and S chosen from (D, F)
//     alone, so that each phase has about one unit an SM).
//   Weights: TMA boxes of 32 rows x 64 bf16 columns (4 KB of 128-byte rows,
//     as K7q's) with the 128-byte swizzle, eight a stage (32 KB), through
//     one ring of 3 stages guarded by mbarriers that runs on from w13's
//     stages into w2's (32-row stages x 3 read 1-2% faster than 16-row
//     stages x 4 at the 1B widths, and equal at the 7B ones). Thread 0
//     fills the ring, and the last of the eight warps to finish a stage (a
//     shared-memory count) refills it.
//   Products: mma.sync m16n8k16 bf16 with f32 sums, the weights as A (16
//     columns x 16 rows, read with ldmatrix.trans from the swizzled box: no
//     conversion) and the decode rows as B, T = ceil(M / 8) tiles of 8 rows
//     (rows past M zero): each weight fragment feeds T products, so a
//     launch of up to 32 rows reads every weight once. A warp owns one box,
//     64 columns, for the whole split. T is the template argument (4
//     instantiations a kernel); M itself is a run-time mask.
//   Prologue (K7a): thread 0 fills the ring first; meanwhile the block
//     computes the norm's statistic over all of h, 8 rows at a time
//     (rms_norm::inv_rms_rows), and its split's normed rows
//     (rms_norm::normed): bit for bit the norm launch. K7 stages its
//     split's rows of x.
//   Up: each split stores its f32 partial sums; once every split of its
//     column tile has (a barrier of the tile's blocks, all resident), each
//     adds the P partials of its share of the tile's columns in split order,
//     applies SiLU, writes that share of a (M, F) bf16 and counts itself
//     done.
//   Down: the block waits (one thread's relaxed loads) until all of a is
//     out, stages its rows of a, and streams its w2 split; after the tile's
//     barrier each split adds the S partials of its share of the columns in
//     split order into out (K7), or adds h to their bf16 sum (K7a).
// Sums in a fixed order and no float atomics: the same bits every call,
// and a row's bits do not depend on the other rows of its launch. A
// launch's activations are staged whole in shared memory ([M][split rows]
// bf16 beside the 96-KB ring): at Mistral-7B's widths and M 32 that is
// 128.5 KB, just under the 227-KB limit; where a split is longer, the entry
// point makes launches of as many rows as fit (`dispatch`). Scratch
// (partials, a, counters) is the caller's persistent workspace; the
// counters are left zero.
//
// Kernel names: K7's is ffn_kernel<T>; K7a's, ffn_up_kernel_ring<T>, keeps
// the first design's ffn_up_kernel prefix, by which a device trace finds
// K7a's launches (perf_bench/readers.py).
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "rms_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCols = 64;                     // bf16 columns of a box: one swizzled row
constexpr int kBoxes = 8;                        // boxes a stage, one a warp
constexpr int kTileCols = kBoxes * kBoxCols;     // columns a block owns, 64 a warp
constexpr int kRows = 32;                        // weight rows a stage, two k16 steps
constexpr int kBoxBytes = kRows * kBoxCols * 2;  // 4 KB
constexpr int kStageBytes = kBoxes * kBoxBytes;  // 32 KB
constexpr int kStages = 3;                       // 96 KB in flight a block
constexpr int kRowTile = 8;                      // decode rows of an n8 tile of m16n8k16
constexpr int kMaxTiles = 4;
constexpr int kMaxM = kRowTile * kMaxTiles;      // 32 decode rows a launch
constexpr int kPadK = 8;        // bf16 elements past each activation row
constexpr int kAlign = 1024;    // the swizzle's atom
static_assert(kBoxBytes % kAlign == 0 && kRows % 16 == 0, "boxes start on a swizzle atom");
static_assert(rms_norm::kThreads == kThreads, "the norm's statistic runs on the whole block");
// a block's shared memory at the least: more than half an SM's 228 KB, so
// that no SM holds two blocks and the grid spreads over all
constexpr size_t kMinSmem = 116 * 1024;

// Shared memory of a block: the ring (1024-aligned), the activations
// [M][pitch] bf16 (x or xn, then a), K7a's norm statistic (each row's warp
// sums, then its 1 / rms; K7 leaves it unused), the stages' full barriers
// and release counts
struct Smem {
    size_t act, norm, bars, counts, bytes;
    __host__ __device__ Smem(int M, int pitch) {
        act = static_cast<size_t>(kStages) * kStageBytes;
        norm = act + ((sizeof(__nv_bfloat16) * M * pitch + 7) & ~size_t(7));
        bars = norm + ((sizeof(float) * M * (kWarps + 1) + 7) & ~size_t(7));
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lane l names row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// One stage of a warp's box (kRows swizzled rows of 128 bytes, 64 columns)
// for T tiles of decode rows: act_g is this lane's activation row g at the
// stage's first row, tile t's row 8 t + g lies t * tile_pitch further on,
// and bit t of `live` says whether that row is below M. acc[t][j] holds the
// m16n8 sums of columns 16 j + g (c0, c1) and 16 j + g + 8 (c2, c3) for
// decode rows 8 t + 2 q (c0, c2) and 8 t + 2 q + 1 (c1, c3).
template <int T>
__device__ __forceinline__ void stage_products(uint32_t box, const __nv_bfloat16* act_g,
                                               int tile_pitch, unsigned live, int lane,
                                               float (*acc)[4][4]) {
    const int q = lane & 3;
    // matrix mi = lane / 8 of a k16 step: rows 8 (mi / 2) + lane % 8 of the
    // step, columns 16 j + 8 (mi % 2) on: a0 (cols + 0-7, k 0-7), a1 (cols
    // 8-15, k 0-7), a2 (cols 0-7, k 8-15), a3 (cols 8-15, k 8-15),
    // transposed into A
    const int mi = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
        uint32_t b0[T], b1[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
            b0[t] = b1[t] = 0;
            if (live >> t & 1u) {
                const __nv_bfloat16* row = act_g + t * tile_pitch + ks * 16 + 2 * q;
                b0[t] = *reinterpret_cast<const uint32_t*>(row);
                b1[t] = *reinterpret_cast<const uint32_t*>(row + 8);
            }
        }
        const int r = ks * 16 + (lane & 7) + 8 * (mi >> 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int chunk = 2 * j + (mi & 1);  // 16-byte chunk of the 128-byte row
            uint32_t a[4];
            ldmatrix_x4_trans(a, box + r * 128 + ((chunk ^ (r & 7)) << 4));
#pragma unroll
            for (int t = 0; t < T; ++t) mma_bf16(acc[t][j], a, b0[t], b1[t]);
        }
    }
}

// The ring of one block: stages of kBoxes TMA boxes; chunk i < n13 is row
// stage i of the up unit (w13), then chunk n13 + j is row stage j of the down
// unit (w2). Box b of an up stage holds gate columns f0 + 64 b (b < 4) or
// the matching up columns F + f0 + 64 (b - 4); of a down stage, columns
// n0 + 64 b
struct Ring {
    uint8_t* stages;
    uint32_t full;       // shared address of full[kStages]
    int* counts;         // warps done with each stage
    const CUtensorMap *map13, *map2;
    int f0, F, n0;
    int row13, n13, row2, n2;

    __device__ void issue(int i) const {
        const int s = i % kStages;
        hopper::mbar_arrive_expect_tx(full + 8 * s, kStageBytes);
        const uint32_t dst = hopper::smem_u32(stages + s * kStageBytes);
        const bool up = i < n13;
        const int row = up ? row13 + i * kRows : row2 + (i - n13) * kRows;
#pragma unroll
        for (int b = 0; b < kBoxes; ++b) {
            constexpr int half = kBoxes / 2;
            const int col = up ? (b < half ? 0 : F) + f0 + (b % half) * kBoxCols : n0 + b * kBoxCols;
            hopper::tma_load_2d(dst + b * kBoxBytes, up ? map13 : map2, col, row, full + 8 * s);
        }
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

    __device__ uint32_t wait(int i) const {
        const int s = i % kStages;
        hopper::mbar_wait(full + 8 * s, (i / kStages) & 1);
        return hopper::smem_u32(stages + s * kStageBytes);
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

// The warp's products over chunks [begin, end) of the ring: its box within
// each stage; act_g, tile_pitch and live as stage_products takes them at
// the first chunk
template <int T>
__device__ __forceinline__ void stream_chunks(const Ring& ring, int begin, int end, int warp,
                                              int lane, const __nv_bfloat16* act_g,
                                              int tile_pitch, unsigned live,
                                              float (*acc)[4][4]) {
    for (int i = begin; i < end; ++i) {
        const uint32_t stage = ring.wait(i);
        stage_products<T>(stage + warp * kBoxBytes, act_g + (i - begin) * kRows, tile_pitch,
                          live, lane, acc);
        ring.release(i, lane);
    }
}

// The warp's sums for decode rows 8 t + 2 q and 8 t + 2 q + 1 (< M) at
// columns base + 16 j + g and + 8, to part (rows of `ld` floats), masked at
// `limit`
template <int T>
__device__ __forceinline__ void store_partials(float* part, size_t ld, int base, int limit, int M,
                                               int lane, float (*acc)[4][4]) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = base + 16 * j + g + 8 * h, m = kRowTile * t + 2 * q;
                if (c >= limit) continue;
                if (m < M) part[m * ld + c] = acc[t][j][2 * h];
                if (m + 1 < M) part[(m + 1) * ld + c] = acc[t][j][2 * h + 1];
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

// Loads a thread keeps in flight in the loops between the phases, whose
// work grows with M: the staging of a split's rows and the sums over splits
constexpr int kBatch = 4;

// Rows [k0, k0 + rows) of the (M, width) bf16 matrix src into act [M][pitch],
// 8 values a load (width and k0 multiples of 8), zeros past `rows`; `cg`
// reads around L1, for what other blocks wrote during this launch
template <bool cg>
__device__ __forceinline__ void stage_act(__nv_bfloat16* act, int pitch, int M,
                                          const __nv_bfloat16* src, int width, int k0, int rows) {
    const int n = M * pitch / 8;
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kThreads, m = i / (pitch / 8), k = (i % (pitch / 8)) * 8;
            v[u] = make_uint4(0, 0, 0, 0);
            if (i < n && k < rows) {
                const uint4* p =
                    reinterpret_cast<const uint4*>(src + static_cast<size_t>(m) * width + k0 + k);
                v[u] = cg ? __ldcg(p) : __ldg(p);
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            if (i0 + u * kThreads < n) reinterpret_cast<uint4*>(act)[i0 + u * kThreads] = v[u];
    }
}

// K7a's prologue: xn = rms_norm(h) for rows [k0, k0 + rows) of D into act
// [M][pitch], bit for bit rms_norm's launch, zeros past `rows`; 8 columns of
// 8 rows a thread at a time, staged in registers. warp_part [M][kWarps] and
// inv_rms [M] are shared memory.
template <int T>
__device__ __forceinline__ void stage_normed(__nv_bfloat16* act, int pitch, int M,
                                             const __nv_bfloat16* h,
                                             const __nv_bfloat16* norm_w, int D, int k0,
                                             int rows, float eps, float (*warp_part)[kWarps],
                                             float* inv_rms) {
#pragma unroll 1
    for (int t = 0; t < T; ++t)
        rms_norm::inv_rms_rows<kRowTile, true>(h + static_cast<size_t>(kRowTile) * t * D, D, eps,
                                               warp_part + kRowTile * t, inv_rms + kRowTile * t,
                                               min(kRowTile, M - kRowTile * t));
    for (int k = threadIdx.x * 8; k < pitch; k += kThreads * 8) {
        __align__(16) __nv_bfloat16 nv[8];
        if (k < rows) *reinterpret_cast<uint4*>(nv) = *reinterpret_cast<const uint4*>(norm_w + k0 + k);
#pragma unroll 1
        for (int t = 0; t < T; ++t) {
            __align__(16) __nv_bfloat16 hv[kRowTile * 8];
#pragma unroll
            for (int r = 0; r < kRowTile; ++r) {
                const int m = kRowTile * t + r;
                if (k < rows && m < M)
                    *reinterpret_cast<uint4*>(hv + 8 * r) =
                        *reinterpret_cast<const uint4*>(h + static_cast<size_t>(m) * D + k0 + k);
            }
#pragma unroll
            for (int r = 0; r < kRowTile; ++r) {
                const int m = kRowTile * t + r;
                if (m >= M) continue;
                __align__(16) __nv_bfloat16 v[8];
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    v[j] = f2bf(k < rows ? rms_norm::normed(hv, nv, inv_rms[m], r, j, 8) : 0.f);
                *reinterpret_cast<uint4*>(act + m * pitch + k) = *reinterpret_cast<uint4*>(v);
            }
        }
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

struct Params {
    const __nv_bfloat16* x;       // (M, D): K7's normed rows, or K7a's stream h
    const __nv_bfloat16* norm_w;  // (D,), K7a only
    float* part13;                // (P, M, 2F) partial sums
    __nv_bfloat16* a;             // (M, F), written by the up units
    float* part2;                 // (S, M, D) partial sums
    Counters cnt;                 // zero, and left zero
    void* out;                    // (M, D): f32 (K7), or bf16 (K7a)
    int M, D, F, P, S, pitch;
    float eps;
};

// The whole launch, for T = ceil(M / 8) tiles of decode rows; kBlock: K7a
// (the norm prologue and the residual epilogue), else K7
template <int T, bool kBlock>
__device__ __forceinline__ void ffn_ring(const CUtensorMap* map13, const CUtensorMap* map2,
                                         const Params& p) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    uint8_t* smem = smem_raw + (((raw + kAlign - 1) & ~uint32_t(kAlign - 1)) - raw);
    const int M = p.M, D = p.D, F = p.F, P = p.P, S = p.S, pitch = p.pitch;
    const Smem L(M, pitch);
    __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + L.act);  // [M][pitch]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
    unsigned live = 0;  // the tiles in which this lane's row g is a decode row
#pragma unroll
    for (int t = 0; t < T; ++t) live |= (kRowTile * t + g < M ? 1u : 0u) << t;
    const int tiles13 = (F + kTileCols / 2 - 1) / (kTileCols / 2);
    const int tiles2 = (D + kTileCols - 1) / kTileCols;
    const int b = blockIdx.x;
    const bool has13 = b < tiles13 * P, has2 = b < tiles2 * S;
    const int tile13 = b / P, sp = b % P, f0 = tile13 * (kTileCols / 2);
    const int tile2 = b / S, s = b % S, n0 = tile2 * kTileCols;
    int c13 = 0, e13 = 0, c2 = 0, e2 = 0;
    if (has13) share(sp, P, (D + kRows - 1) / kRows, c13, e13);  // the last may pass D: TMA zeros
    if (has2) share(s, S, (F + kRows - 1) / kRows, c2, e2);

    const Ring ring{smem, hopper::smem_u32(smem + L.bars), reinterpret_cast<int*>(smem + L.counts),
                    map13, map2, f0, F, n0, c13 * kRows, e13 - c13, c2 * kRows, e2 - c2};
    if (tid == 0) ring.start();
    float acc[T][4][4];

    if (has13) {
        // this split's rows of x (K7) or xn (K7a), zeros past the split and
        // past D, where TMA gives zero weights
        const int k0 = c13 * kRows, rows = min(D, e13 * kRows) - k0;
        if constexpr (kBlock) {
            float* norm = reinterpret_cast<float*>(smem + L.norm);
            stage_normed<T>(act, pitch, M, p.x, p.norm_w, D, k0, rows, p.eps,
                            reinterpret_cast<float(*)[kWarps]>(norm), norm + M * kWarps);
        } else {
            stage_act<false>(act, pitch, M, p.x, D, k0, rows);
        }
        __syncthreads();

        for (int i = 0; i < T * 16; ++i) (&acc[0][0][0])[i] = 0.f;
        stream_chunks<T>(ring, 0, ring.n13, warp, lane, act + g * pitch, kRowTile * pitch, live,
                         acc);
        // warps 0-3 hold gate columns f0 + 64 w ..., warps 4-7 the up columns
        store_partials<T>(p.part13 + static_cast<size_t>(sp) * M * 2 * F + (warp < 4 ? 0 : F),
                          2 * F, f0 + 64 * (warp & 3), F, M, lane, acc);
        tile_barrier(p.cnt.tile13 + 2 * tile13, P);
        int f_beg, f_end;
        share(sp, P, kTileCols / 2, f_beg, f_end);
        const int width13 = f_end - f_beg, n13 = M * width13;
        for (int i0 = tid; i0 < n13; i0 += kThreads * kBatch) {
            float gs[kBatch], us[kBatch];
            int mf[kBatch][2];  // each item's row m and column f, or m -1 past the share
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int i = i0 + u * kThreads, f = f0 + f_beg + i % width13;
                mf[u][0] = i < n13 && f < F ? i / width13 : -1;
                mf[u][1] = f;
                gs[u] = us[u] = 0.f;
            }
#pragma unroll 4
            for (int j = 0; j < P; ++j) {  // the splits in order
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    if (mf[u][0] < 0) continue;
                    const float* pj =
                        p.part13 + (static_cast<size_t>(j) * M + mf[u][0]) * 2 * F + mf[u][1];
                    gs[u] += __ldcg(pj);
                    us[u] += __ldcg(pj + F);
                }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                if (mf[u][0] < 0) continue;
                const float silu = gs[u] / (1.f + expf(-gs[u]));
                p.a[static_cast<size_t>(mf[u][0]) * F + mf[u][1]] = f2bf(silu * us[u]);
            }
        }
        tile_leave(p.cnt.tile13 + 2 * tile13, P);
        __syncthreads();
        if (tid == 0) {
            __threadfence();
            atomicAdd(p.cnt.done13, 1u);  // this unit's share of a is out
        }
    }
    if (!has2) return;

    // every tile of a, then this split's rows of it
    if (tid == 0) {
        wait_count(p.cnt.done13, tiles13 * P);
        // the last block past the wait leaves both counts zero
        if (atomicAdd(p.cnt.passed, 1u) == static_cast<unsigned int>(tiles2 * S) - 1) {
            *p.cnt.done13 = 0;
            *p.cnt.passed = 0;
        }
    }
    __syncthreads();
    const int k0 = c2 * kRows;
    stage_act<true>(act, pitch, M, p.a, F, k0, min(F, e2 * kRows) - k0);
    __syncthreads();

    for (int i = 0; i < T * 16; ++i) (&acc[0][0][0])[i] = 0.f;
    stream_chunks<T>(ring, ring.n13, ring.n13 + ring.n2, warp, lane, act + g * pitch,
                     kRowTile * pitch, live, acc);
    store_partials<T>(p.part2 + static_cast<size_t>(s) * M * D, D, n0 + 64 * warp, D, M, lane,
                      acc);
    tile_barrier(p.cnt.tile2 + 2 * tile2, S);
    int n_beg, n_end;
    share(s, S, kTileCols, n_beg, n_end);
    const int width = n_end - n_beg;
    for (int i = tid; i < M * width; i += kThreads) {
        const int m = i / width, n = n0 + n_beg + i % width;
        if (n >= D) continue;
        float y = 0.f;
#pragma unroll 16
        for (int j = 0; j < S; ++j) y += __ldcg(p.part2 + (static_cast<size_t>(j) * M + m) * D + n);
        const size_t o = static_cast<size_t>(m) * D + n;
        if constexpr (kBlock)
            static_cast<__nv_bfloat16*>(p.out)[o] = f2bf(bf2f(p.x[o]) + round_bf16(y));
        else
            static_cast<float*>(p.out)[o] = y;
    }
    tile_leave(p.cnt.tile2 + 2 * tile2, S);
}

// K7
template <int T>
__global__ void __launch_bounds__(kThreads, 1) ffn_kernel(
    const __grid_constant__ CUtensorMap map13,  // w13 (D, 2F) bf16, boxes of 32 x 64
    const __grid_constant__ CUtensorMap map2,   // w2 (F, D) bf16, boxes of 32 x 64
    const __grid_constant__ Params p) {
    ffn_ring<T, false>(&map13, &map2, p);
}

// K7a
template <int T>
__global__ void __launch_bounds__(kThreads, 1) ffn_up_kernel_ring(
    const __grid_constant__ CUtensorMap map13, const __grid_constant__ CUtensorMap map2,
    const __grid_constant__ Params p) {
    ffn_ring<T, true>(&map13, &map2, p);
}

// a bf16 (rows, cols) row-major matrix in boxes of kRows x kBoxCols, the
// 128-byte swizzle, zeros past its edges; cols a multiple of 8
cudaError_t weight_map(CUtensorMap* map, const void* w, int rows, int cols) {
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
    const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * 2};
    const cuuint32_t box[2] = {kBoxCols, kRows};
    const cuuint32_t steps[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, stride,
                  box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                   CUDA_SUCCESS
               ? cudaSuccess : cudaErrorInvalidValue;
}

template <int T, bool kBlock>
int launch(const void* w13, const void* w2, void* counters, Params p, cudaStream_t stream) {
    auto* const kernel = kBlock ? ffn_up_kernel_ring<T> : ffn_kernel<T>;
    static const int smem_max = hopper::allow_smem(kernel);  // allowed once
    if (smem_max < 0) return cudaErrorInvalidDeviceFunction;
    const Smem L(p.M, p.pitch);
    const size_t smem = L.bytes > kMinSmem ? L.bytes : kMinSmem;
    if (smem > static_cast<size_t>(smem_max)) return PREGO_BAD_ARGUMENT;
    const int tiles13 = (p.F + kTileCols / 2 - 1) / (kTileCols / 2);
    const int tiles2 = (p.D + kTileCols - 1) / kTileCols;
    const int blocks = tiles13 * p.P > tiles2 * p.S ? tiles13 * p.P : tiles2 * p.S;
    if (blocks > hopper::num_sms()) return PREGO_BAD_ARGUMENT;
    CUtensorMap map13, map2;
    cudaError_t err;
    if ((err = weight_map(&map13, w13, p.D, 2 * p.F)) != cudaSuccess) return err;
    if ((err = weight_map(&map2, w2, p.F, p.D)) != cudaSuccess) return err;
    unsigned int* c = static_cast<unsigned int*>(counters);
    p.cnt = Counters{c, c + 2 * tiles13, c + 2 * (tiles13 + tiles2), c + 2 * (tiles13 + tiles2) + 1};
    void* args[] = {&map13, &map2, &p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                      dim3(kThreads), args, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// The most of M rows whose activations fit a block's shared memory beside
// the ring, at `pitch` bf16 a row: all 32 for a split of 2,048 rows
// (Mistral-7B's widths), 25 for 2,560 (13B's), 16 for 4,096, the longest
// ring_splits in ops/fused_ffn.py gives
int fitting_rows(int M, int pitch) {
    static const int optin = [] {
        int dev = 0, bytes = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        return bytes;
    }();
    while (M > 0 && Smem(M, pitch).bytes > static_cast<size_t>(optin)) --M;
    return M;
}

// The call's rows in launches of as many as fit shared memory (one launch
// but where a split is long), each on T = ceil(rows / 8) tiles; a row's
// bits do not depend on its launch
template <bool kBlock>
int dispatch(const void* w13, const void* w2, void* counters, Params p, void* stream) {
    if (p.M < 1 || p.M > kMaxM || p.D <= 0 || p.F <= 0 || p.D % 16 != 0 || p.F % 16 != 0 ||
        p.P < 1 || p.S < 1 || p.P > (p.D + kRows - 1) / kRows || p.S > (p.F + kRows - 1) / kRows)
        return PREGO_BAD_ARGUMENT;
    const int chunks13 = (p.D + kRows - 1) / kRows, chunks2 = (p.F + kRows - 1) / kRows;
    const int rows13 = (chunks13 + p.P - 1) / p.P * kRows, rows2 = (chunks2 + p.S - 1) / p.S * kRows;
    p.pitch = (rows13 > rows2 ? rows13 : rows2) + kPadK;
    const int rows = fitting_rows(p.M, p.pitch);
    if (rows < 1) return PREGO_BAD_ARGUMENT;
    const size_t out_row = (kBlock ? sizeof(__nv_bfloat16) : sizeof(float)) * p.D;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int m0 = 0; m0 < p.M; m0 += rows) {
        Params q = p;
        q.M = p.M - m0 < rows ? p.M - m0 : rows;
        q.x = p.x + static_cast<size_t>(m0) * p.D;
        q.out = static_cast<uint8_t*>(p.out) + m0 * out_row;
        int err;
        switch ((q.M + kRowTile - 1) / kRowTile) {
            case 1: err = launch<1, kBlock>(w13, w2, counters, q, st); break;
            case 2: err = launch<2, kBlock>(w13, w2, counters, q, st); break;
            case 3: err = launch<3, kBlock>(w13, w2, counters, q, st); break;
            default: err = launch<4, kBlock>(w13, w2, counters, q, st);
        }
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// K7: out (M, D) f32 = silu(x.W1) * (x.W3) . W2 for x (M, D), w13 (D, 2F)
// and w2 (F, D), all bf16. 1 <= M <= 32; D and F multiples of 16 (TMA
// starts a box at a 16-byte boundary: the up columns begin at column F).
// P splits of D and S of F, at most one unit a block and one block an SM.
// Workspace: part13 (P, M, 2F) and part2 (S, M, D) f32, a (M, F) bf16, and
// counters (2 ceil(F / 256) + 2 ceil(D / 512) + 2) int32, zero, which the
// call leaves zero.
PREGO_EXPORT int prego_fused_ffn_tma(const void* x, const void* w13, const void* w2,
                                     void* part13, void* a, void* part2, void* counters,
                                     void* out, int M, int D, int F, int P, int S, void* stream) {
    const Params p{static_cast<const __nv_bfloat16*>(x), nullptr, static_cast<float*>(part13),
                   static_cast<__nv_bfloat16*>(a), static_cast<float*>(part2), Counters{}, out,
                   M, D, F, P, S, 0, 0.f};
    return dispatch<false>(w13, w2, counters, p, stream);
}

// K7a: out (M, D) bf16 = h + FFN(rms_norm(h)) for h (M, D), norm_w (D,),
// w13 (D, 2F) and w2 (F, D), all bf16. Bounds, splits and workspace as
// K7's.
PREGO_EXPORT int prego_fused_ffn_block_tma(const void* h, const void* norm_w, const void* w13,
                                           const void* w2, void* part13, void* a, void* part2,
                                           void* counters, void* out, int M, int D, int F, int P,
                                           int S, float eps, void* stream) {
    const Params p{static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(norm_w),
                   static_cast<float*>(part13), static_cast<__nv_bfloat16*>(a),
                   static_cast<float*>(part2), Counters{}, out, M, D, F, P, S, 0, eps};
    return dispatch<true>(w13, w2, counters, p, stream);
}
