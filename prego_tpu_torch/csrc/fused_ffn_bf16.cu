// K7: the decode FFN over bf16 weights, on Hopper.
//
// Replaces prego_tpu/ops/fused_ffn.py::fused_ffn (Pallas body
// _fused_ffn_kernel). For M <= 8 normed decode rows x (M, D) bf16:
//   a   = bf16(silu(x.W1) * (x.W3))                    (f32 sums)
//   out = a.W2                                          (f32, the caller casts)
// with w13 = [W1 | W3] (D, 2F) and w2 (F, D) bf16.
//
// What bounds it here: the weights' bytes. A call streams D x 3F bf16 once
// (69.2 MB at D 2048, F 5632: 20.7 us at 3.35 TB/s; 270.5 MB at the 7B
// widths) for 6 M D F operations, far below the tensor cores' break-even;
// the work is to keep the card's memory busy from the first byte to the
// last. The first design (fused_ffn.cu, K7a's kernels without the norm and
// the residual) made three launches with 8-byte loads a thread and f32
// FMAs, and streamed w2 only after the up phase had ended.
//
// Design: K7q's (fused_ffn_q8.cu) over bf16 weights, without its norm
// prologue, its scales and its residual epilogue. One persistent launch,
// one block on every SM (cooperative, so all are resident; its shared
// memory keeps a second block off an SM).
//   Work: block b owns up unit b, a column tile of 256 gate and 256 up
//     columns over one of P splits of D, and then down unit b, a tile of 512
//     output columns over one of S splits of F (P and S chosen so that each
//     phase has about one unit an SM).
//   Weights: TMA boxes of 32 rows x 64 bf16 columns (4 KB of 128-byte rows,
//     as K7q's) with the 128-byte swizzle, eight a stage (32 KB), through
//     one ring of 3 stages guarded by mbarriers that runs on from w13's
//     stages into w2's (32-row stages x 3 read 1-2% faster than 16-row
//     stages x 4 at the 1B widths, and equal at the 7B ones). Thread 0
//     fills the ring, and the last of the eight warps to finish a stage (a
//     shared-memory count) refills it.
//   Products: mma.sync m16n8k16 bf16 with f32 sums, the weights as A (16
//     columns x 16 rows, read with ldmatrix.trans from the swizzled box: no
//     conversion) and the decode rows as B (16 rows x 8 decode rows, the
//     rows past M zero), so every row count up to 8 costs the same. A warp
//     owns one box, 64 columns, for the whole split.
//   Up: each split stores its f32 partial sums; once every split of its
//     column tile has (a barrier of the tile's blocks, all resident), each
//     adds the P partials of its share of the tile's columns in split order,
//     applies SiLU, writes that share of a (M, F) bf16 and counts itself
//     done.
//   Down: the block waits (one thread's relaxed loads) until all of a is
//     out, stages its rows of a, and streams its w2 split; after the tile's
//     barrier each split adds the S partials of its share of the columns in
//     split order into out.
// Sums in a fixed order and no float atomics: the same bits every call.
// Scratch (partials, a, counters) is the caller's persistent workspace; the
// counters are left zero.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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
constexpr int kMaxM = 8;
constexpr int kPadK = 8;        // bf16 elements past each activation row
constexpr int kAlign = 1024;    // the swizzle's atom
static_assert(kBoxBytes % kAlign == 0 && kRows % 16 == 0, "boxes start on a swizzle atom");
// a block's shared memory at the least: more than half an SM's 228 KB, so
// that no SM holds two blocks and the grid spreads over all
constexpr size_t kMinSmem = 116 * 1024;

// Shared memory of a block: the ring (1024-aligned), the activations
// [M][pitch] bf16 (x, then a), the stages' full barriers and release counts
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

// One stage of a warp's box (kRows swizzled rows of 128 bytes, 64 columns):
// act_g is this lane's activation row g at the stage's first row, or null
// past M. acc[j] holds the m16n8 sums of columns 16 j + g (c0, c1) and
// 16 j + g + 8 (c2, c3) for decode rows 2 q (c0, c2) and 2 q + 1 (c1, c3).
__device__ __forceinline__ void stage_products(uint32_t box, const __nv_bfloat16* act_g,
                                               int lane, float (*acc)[4]) {
    const int q = lane & 3;
    // matrix mi = lane / 8 of a k16 step: rows 8 (mi / 2) + lane % 8 of the
    // step, columns 16 j + 8 (mi % 2) on: a0 (cols + 0-7, k 0-7), a1 (cols
    // 8-15, k 0-7), a2 (cols 0-7, k 8-15), a3 (cols 8-15, k 8-15),
    // transposed into A
    const int mi = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
        uint32_t b0 = 0, b1 = 0;
        if (act_g != nullptr) {
            b0 = *reinterpret_cast<const uint32_t*>(act_g + ks * 16 + 2 * q);
            b1 = *reinterpret_cast<const uint32_t*>(act_g + ks * 16 + 2 * q + 8);
        }
        const int r = ks * 16 + (lane & 7) + 8 * (mi >> 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int chunk = 2 * j + (mi & 1);  // 16-byte chunk of the 128-byte row
            uint32_t a[4];
            ldmatrix_x4_trans(a, box + r * 128 + ((chunk ^ (r & 7)) << 4));
            mma_bf16(acc[j], a, b0, b1);
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
// each stage, act_g its lane's activation row (or null)
__device__ __forceinline__ void stream_chunks(const Ring& ring, int begin, int end, int warp,
                                              int lane, const __nv_bfloat16* act_g,
                                              float (*acc)[4]) {
    for (int i = begin; i < end; ++i) {
        const uint32_t stage = ring.wait(i);
        stage_products(stage + warp * kBoxBytes, act_g ? act_g + (i - begin) * kRows : nullptr,
                       lane, acc);
        ring.release(i, lane);
    }
}

// The warp's sums for decode rows 2 q and 2 q + 1 (< M) at columns
// base + 16 j + g and + 8, to part (rows of `ld` floats), masked at `limit`
template <int M>
__device__ __forceinline__ void store_partials(float* part, size_t ld, int base, int limit,
                                               int lane, float (*acc)[4]) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = base + 16 * j + g + 8 * h;
            if (c >= limit) continue;
            if (2 * q < M) part[(2 * q) * ld + c] = acc[j][2 * h];
            if (2 * q + 1 < M) part[(2 * q + 1) * ld + c] = acc[j][2 * h + 1];
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

// Rows [k0, k0 + rows) of the (M, width) bf16 matrix src into act [M][pitch],
// 8 values a load (width and k0 multiples of 8), zeros past `rows`; `cg`
// reads around L1, for what other blocks wrote during this launch
template <int M, bool cg>
__device__ __forceinline__ void stage_act(__nv_bfloat16* act, int pitch,
                                          const __nv_bfloat16* src, int width, int k0, int rows) {
    for (int i = threadIdx.x; i < M * pitch / 8; i += kThreads) {
        const int m = i / (pitch / 8), k = (i % (pitch / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < rows) {
            const uint4* p = reinterpret_cast<const uint4*>(src + static_cast<size_t>(m) * width + k0 + k);
            v = cg ? __ldcg(p) : __ldg(p);
        }
        reinterpret_cast<uint4*>(act)[i] = v;
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
__global__ void __launch_bounds__(kThreads, 1) ffn_kernel(
    const __grid_constant__ CUtensorMap map13,  // w13 (D, 2F) bf16, boxes of 16 x 64
    const __grid_constant__ CUtensorMap map2,   // w2 (F, D) bf16, boxes of 16 x 64
    const __nv_bfloat16* __restrict__ x,        // (M, D)
    float* __restrict__ part13,                 // (P, M, 2F) partial sums
    __nv_bfloat16* a,                           // (M, F), written by the up units
    float* __restrict__ part2,                  // (S, M, D) partial sums
    Counters cnt,                               // zero, and left zero
    float* __restrict__ out,                    // (M, D)
    int D, int F, int P, int S, int pitch) {
    extern __shared__ uint8_t smem_raw[];
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
                    &map13, &map2, f0, F, n0, c13 * kRows, e13 - c13, c2 * kRows, e2 - c2};
    if (tid == 0) ring.start();
    float acc[4][4];

    if (has13) {
        // this split's rows of x, zeros past the split and past D, where
        // TMA gives zero weights
        const int k0 = c13 * kRows;
        stage_act<M, false>(act, pitch, x, D, k0, min(D, e13 * kRows) - k0);
        __syncthreads();

        for (int i = 0; i < 16; ++i) (&acc[0][0])[i] = 0.f;
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

    // every tile of a, then this split's rows of it
    if (tid == 0) {
        wait_count(cnt.done13, tiles13 * P);
        // the last block past the wait leaves both counts zero
        if (atomicAdd(cnt.passed, 1u) == static_cast<unsigned int>(tiles2 * S) - 1) {
            *cnt.done13 = 0;
            *cnt.passed = 0;
        }
    }
    __syncthreads();
    const int k0 = c2 * kRows;
    stage_act<M, true>(act, pitch, a, F, k0, min(F, e2 * kRows) - k0);
    __syncthreads();

    for (int i = 0; i < 16; ++i) (&acc[0][0])[i] = 0.f;
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
        out[static_cast<size_t>(m) * D + n] = y;
    }
    tile_leave(cnt.tile2 + 2 * tile2, S);
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

struct Args {
    const void *x, *w13, *w2;
    void *part13, *a, *part2, *counters, *out;
    int D, F, P, S;
};

template <int M>
int launch(const Args& x, cudaStream_t stream) {
    static const int smem_max = hopper::allow_smem(ffn_kernel<M>);  // allowed once
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
    const __nv_bfloat16* xs = static_cast<const __nv_bfloat16*>(x.x);
    float* part13 = static_cast<float*>(x.part13);
    __nv_bfloat16* a = static_cast<__nv_bfloat16*>(x.a);
    float* part2 = static_cast<float*>(x.part2);
    float* out = static_cast<float*>(x.out);
    int D = x.D, F = x.F, P = x.P, S = x.S, pitch_ = pitch;
    void* args[] = {&map13, &map2, &xs, &part13, &a, &part2, &cnt, &out, &D, &F, &P, &S, &pitch_};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ffn_kernel<M>), dim3(blocks),
                                      dim3(kThreads), args, smem, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K7: out (M, D) f32 = silu(x.W1) * (x.W3) . W2 for x (M, D), w13 (D, 2F)
// and w2 (F, D), all bf16. 1 <= M <= 8; D and F multiples of 16 (TMA
// starts a box at a 16-byte boundary: the up columns begin at column F).
// P splits of D and S of F, at most one unit a block and one block an SM.
// Workspace: part13 (P, M, 2F) and part2 (S, M, D) f32, a (M, F) bf16, and
// counters (2 ceil(F / 256) + 2 ceil(D / 512) + 2) int32, zero, which the
// call leaves zero.
PREGO_EXPORT int prego_fused_ffn_tma(const void* x, const void* w13, const void* w2,
                                     void* part13, void* a, void* part2, void* counters,
                                     void* out, int M, int D, int F, int P, int S, void* stream) {
    if (M < 1 || M > kMaxM || D <= 0 || F <= 0 || D % 16 != 0 || F % 16 != 0 || P < 1 ||
        S < 1 || P > (D + kRows - 1) / kRows || S > (F + kRows - 1) / kRows)
        return PREGO_BAD_ARGUMENT;
    const Args args{x, w13, w2, part13, a, part2, counters, out, D, F, P, S};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (M) {
        case 1: return launch<1>(args, st);
        case 2: return launch<2>(args, st);
        case 3: return launch<3>(args, st);
        case 4: return launch<4>(args, st);
        case 5: return launch<5>(args, st);
        case 6: return launch<6>(args, st);
        case 7: return launch<7>(args, st);
        default: return launch<8>(args, st);
    }
}
