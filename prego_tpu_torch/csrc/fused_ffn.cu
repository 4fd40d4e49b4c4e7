// K7a: the decode FFN sub-layer h + FFN(rms_norm(h)) on Hopper; K7, the
// FFN alone; and K7q, K7a over int8 weights.
//
// K7a replaces prego_tpu/ops/fused_ffn.py::fused_ffn_block (Pallas body
// _fused_ffn_block_kernel). For M decode rows:
//   xn  = bf16(h * rsqrt(mean(h^2) + eps)) * norm_w    (f32 stats, bf16 scale)
//   a   = bf16(silu(xn.W1) * (xn.W3))                   (f32 accumulate)
//   out = h + bf16(a.W2)                                (residual in h's dtype)
// with w13 = [W1 | W3] stored (D, 2F) and w2 (F, D), both bf16.
// K7 replaces ::fused_ffn (Pallas body _fused_ffn_kernel): the same up and
// down phases on an x that comes in normed, without the norm phase and the
// residual; out = a.W2 in f32. K7q replaces ::fused_ffn_block_q8 (Pallas
// body _fused_ffn_block_q8_kernel): K7a with w13 and w2 int8 and one f32
// scale per column, s13 (2F,) and s2 (D,):
//   a   = bf16(silu((xn.W1q) s1) * ((xn.W3q) s3))      (scales after the dot)
//   out = h + bf16((a.W2q) s2)                          (s2 on the final sum)
// One set of kernels serves all three: K7 is the compile-time flag kBlock =
// false, K7q the weight type W = int8_t.
//
// Which shapes come here: this is the three kernels' first design, 8 rows a
// launch. K7a and K7 run it only where the TMA ring of fused_ffn_bf16.cu
// cannot take the weights (D or F no multiple of 16, more column tiles than
// SMs, a split past shared memory: ops/fused_ffn.py::ring_splits), and K7q
// where fused_ffn_q8.cu's ring cannot; every other shape, the cells' among
// them, takes the ring.
//
// What bounds it here: at M <= 8 rows this is pure weight streaming.
// Every weight is used M times, so the sub-layer reads 3 x D x F bf16
// (270 MB per layer at D = 4096, F = 11008) for 6 x M x D x F FLOPs, far
// below the tensor cores' break-even of ~295 FLOPs per byte: device
// memory bandwidth is the limit (81 us per layer at 3.35 TB/s; K7q reads
// half the bytes, 40 us), and the work is to keep enough loads in flight on
// every SM.
//
// Design: four deterministic launches of GEMV-style kernels with f32 FMA.
// The TPU kernel walks F tiles in a sequential grid and accumulates the
// down projection in VMEM; here blocks run in parallel and in no order, and
// no float atomics are used, so the F reduction of W2 is split across
// blocks and summed in a fixed order by a last small pass.
//   0. norm (one block per row, K7a and K7q; rms_norm.cuh): xn, stored
//      transposed (D, M), so that one vector load gives a weight row's M
//      activations.
//   1. up (grid F / 32): each block copies xn into shared memory (M x 8
//      KB at D = 4096, from L2; K7 reads x's rows and stores them
//      transposed, as phase 0 would), then computes 32 gate and 32 up columns
//      of xn.w13 (per weight row, 8 threads x 4 columns read 64 contiguous
//      gate bytes and 8 more the matching up bytes, 32 and 32 in int8, each
//      byte converted to f32 exactly (common.cuh); 16 row groups), reduces
//      across row groups with shuffles and shared memory, applies the
//      column scales (K7q), and writes a = bf16(silu(g) u) transposed to
//      (F, M), so the next phase reads a row of a as M contiguous values.
//   2. down (grid D / 64 x S splits of F): partial sums of a.W2 for 64
//      output columns over one split, f32, to a (S, M, D) scratch.
//   3. reduce (one thread per output): out = h + bf16(sum over splits)
//      (K7a), h + bf16(sum x s2) (K7q), or the f32 sum (K7).
#include <stdint.h>

#include "common.cuh"
#include "rms_norm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUpCols = 32;    // gate (and up) columns per up block
constexpr int kDownCols = 64;  // output columns per down block
constexpr int kMaxM = 8;

// 4 consecutive bf16 (8 bytes) -> 4 floats
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf16x2_to_float2(raw.x), b = bf16x2_to_float2(raw.y);
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
}

// 4 consecutive int8 (4 bytes) -> 4 floats, exactly
__device__ __forceinline__ void load4(const int8_t* p, float* out) {
    int8x4_to_float(*reinterpret_cast<const unsigned int*>(p), out);
}

// M consecutive bf16 -> M floats, with the widest aligned load (rows of M
// values start at multiples of M elements)
template <int M>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
    if constexpr (M == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 v = bf16x2_to_float2(w[i]);
            out[2 * i] = v.x;
            out[2 * i + 1] = v.y;
        }
    } else if constexpr (M == 4) {
        load4(p, out);
    } else if constexpr (M == 2) {
        const float2 v = bf16x2_to_float2(*reinterpret_cast<const unsigned int*>(p));
        out[0] = v.x;
        out[1] = v.y;
    } else {
#pragma unroll
        for (int m = 0; m < M; ++m) out[m] = bf2f(p[m]);
    }
}

// kTransposed: x is xn_t (D, M) from the norm phase (K7a, K7q); else x is
// the normed rows (M, D) (K7), stored transposed into shared memory here.
// W: the weights' type, bf16, or int8 with the column scales s13 (K7q).
template <int M, bool kTransposed, typename W>
__global__ void __launch_bounds__(kThreads) ffn_up_kernel(
    const __nv_bfloat16* __restrict__ x,  // (D, M), or (M, D)
    const W* __restrict__ w13,            // (D, 2F)
    const float* __restrict__ s13,        // (2F,), int8 weights only
    __nv_bfloat16* __restrict__ a_t,      // (F, M) scratch
    int D, int F) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][M]: a row's M values
    float* red = reinterpret_cast<float*>(smem);                   // reused after the sweep
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the normed activations, 16 bytes a load (D x M is a multiple of 8)
    for (int i = tid; i < D * M / 8; i += kThreads) {
        const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
        if constexpr (kTransposed) {
            reinterpret_cast<uint4*>(xn)[i] = raw;
        } else {  // 8 values of row m from column d on
            const int m = (i * 8) / D, d = (i * 8) % D;
            const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int j = 0; j < 8; ++j) xn[(d + j) * M + m] = v[j];
        }
    }
    __syncthreads();

    // xn . w13 for this block's 32 gate and 32 up columns: in each group
    // of 16 threads, threads 0-7 take 4 gate columns each and threads 8-15
    // the matching up columns, so a thread carries M x 4 sums (registers
    // bound the blocks an SM holds, and with them the loads in flight)
    const int f0 = blockIdx.x * kUpCols;
    const int cq = tid % 16, dg = tid / 16;  // 16 row groups
    const int f = f0 + (cq % 8) * 4;
    const size_t col = (cq < 8 ? 0 : static_cast<size_t>(F)) + f;
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    if (f < F) {
        const size_t row = 2 * static_cast<size_t>(F);
#pragma unroll 8
        for (int d = dg; d < D; d += 16) {
            float w[4], x[M];
            load4(w13 + d * row + col, w);
            load_row<M>(xn + d * M, x);
#pragma unroll
            for (int m = 0; m < M; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(x[m], w[j], acc[m][j]);
        }
    }
    // the two row groups of a warp (lanes 0-15, 16-31), then the 8 warps
    // through shared memory
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    __syncthreads();  // xn is dead: its space becomes red[kWarps][M][2 * kUpCols]
    if (lane < 16) {
        // gate columns first, then up: red's column index is cq * 4 + j
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) red[(warp * M + m) * 2 * kUpCols + cq * 4 + j] = acc[m][j];
    }
    __syncthreads();
    for (int idx = tid; idx < M * kUpCols; idx += kThreads) {
        const int m = idx / kUpCols, c = idx % kUpCols;
        if (f0 + c >= F) continue;
        float g = 0.f, u = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            g += red[(w * M + m) * 2 * kUpCols + c];
            u += red[(w * M + m) * 2 * kUpCols + kUpCols + c];
        }
        if constexpr (sizeof(W) == 1) {  // the column scales, after the dot
            g *= s13[f0 + c];
            u *= s13[F + f0 + c];
        }
        const float silu = g / (1.f + expf(-g));
        a_t[static_cast<size_t>(f0 + c) * M + m] = f2bf(silu * u);
    }
}

template <int M, typename W>
__global__ void __launch_bounds__(kThreads) ffn_down_kernel(
    const __nv_bfloat16* __restrict__ a_t,  // (F, M)
    const W* __restrict__ w2,               // (F, D)
    float* __restrict__ part,               // (S, M, D) partial sums
    int D, int F, int rows_per_split) {
    __shared__ float red[kWarps][M][kDownCols];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int d0 = blockIdx.x * kDownCols, s = blockIdx.y;
    const int f_begin = s * rows_per_split, f_end = min(F, f_begin + rows_per_split);
    const int cq = tid % 16, fg = tid / 16;  // 4 columns each, 16 row groups
    const int d = d0 + cq * 4;
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    if (d < D) {
#pragma unroll 4
        for (int f = f_begin + fg; f < f_end; f += 16) {
            float w[4], a[M];
            load4(w2 + static_cast<size_t>(f) * D + d, w);
            load_row<M>(a_t + static_cast<size_t>(f) * M, a);
#pragma unroll
            for (int m = 0; m < M; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(a[m], w[j], acc[m][j]);
        }
    }
    // the two row groups of a warp (lanes 0-15, 16-31)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if (lane < 16) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) red[warp][m][cq * 4 + j] = acc[m][j];
    }
    __syncthreads();
    for (int idx = tid; idx < M * kDownCols; idx += kThreads) {
        const int m = idx / kDownCols, c = idx % kDownCols;
        if (d0 + c >= D) continue;
        float y = 0.f;
        for (int w = 0; w < kWarps; ++w) y += red[w][m][c];
        part[(static_cast<size_t>(s) * M + m) * D + d0 + c] = y;
    }
}

// out = h + bf16(sum over splits) (kBlock), times s2 first (int8 weights),
// or the f32 sum; splits summed in order
template <bool kBlock, typename W>
__global__ void __launch_bounds__(kThreads) ffn_reduce_kernel(
    const __nv_bfloat16* __restrict__ h, const float* __restrict__ part,
    const float* __restrict__ s2, void* __restrict__ out, int MD, int D, int S) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= MD) return;
    float y = 0.f;
    for (int s = 0; s < S; ++s) y += part[static_cast<size_t>(s) * MD + i];
    if constexpr (sizeof(W) == 1) y *= s2[i % D];
    if constexpr (kBlock)
        static_cast<__nv_bfloat16*>(out)[i] = f2bf(bf2f(h[i]) + round_bf16(y));
    else
        static_cast<float*>(out)[i] = y;
}

// The operands of one call; s13 and s2 only with int8 weights, norm_w and
// xn_t only with kBlock
struct Args {
    const void* h;  // the un-normed stream (kBlock), or the normed x (K7)
    const void* norm_w;
    const void* w13;
    const float* s13;
    const void* w2;
    const float* s2;
    void* xn_t;
    void* a_t;
    void* part;
    void* out;
    int D, F, S;
    float eps;
};

// kBlock (K7a, K7q): h is normed into xn_t first; else (K7) h is the normed x
template <int M, bool kBlock, typename W>
int launch(const Args& a, cudaStream_t stream) {
    const size_t xn_bytes = sizeof(__nv_bfloat16) * M * a.D;
    const size_t red_bytes = sizeof(float) * kWarps * M * 2 * kUpCols;
    const size_t smem = xn_bytes > red_bytes ? xn_bytes : red_bytes;
    auto up = ffn_up_kernel<M, kBlock, W>;
    cudaError_t err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if constexpr (kBlock) {
        err = rms_norm::launch<true>(a.h, a.norm_w, a.xn_t, M, a.D, a.eps, stream);
        if (err != cudaSuccess) return err;
    }
    up<<<(a.F + kUpCols - 1) / kUpCols, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(kBlock ? a.xn_t : a.h), static_cast<const W*>(a.w13),
        a.s13, static_cast<__nv_bfloat16*>(a.a_t), a.D, a.F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int rows_per_split = (a.F + a.S - 1) / a.S;
    ffn_down_kernel<M, W><<<dim3((a.D + kDownCols - 1) / kDownCols, a.S), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a.a_t), static_cast<const W*>(a.w2),
        static_cast<float*>(a.part), a.D, a.F, rows_per_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ffn_reduce_kernel<kBlock, W><<<(M * a.D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a.h), static_cast<const float*>(a.part), a.s2, a.out,
        M * a.D, a.D, a.S);
    return cudaGetLastError();
}

template <bool kBlock, typename W>
int dispatch(const Args& a, int M, void* stream) {
    if (M < 1 || M > kMaxM || a.D <= 0 || a.F <= 0 || a.D % 8 != 0 || a.F % 4 != 0 || a.S < 1)
        return PREGO_BAD_ARGUMENT;
    if (sizeof(__nv_bfloat16) * static_cast<size_t>(M) * a.D > 227 * 1024)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (M) {
        case 1: return launch<1, kBlock, W>(a, s);
        case 2: return launch<2, kBlock, W>(a, s);
        case 3: return launch<3, kBlock, W>(a, s);
        case 4: return launch<4, kBlock, W>(a, s);
        case 5: return launch<5, kBlock, W>(a, s);
        case 6: return launch<6, kBlock, W>(a, s);
        case 7: return launch<7, kBlock, W>(a, s);
        default: return launch<8, kBlock, W>(a, s);
    }
}

}  // namespace

// out (M, D) bf16 = h + FFN(rms_norm(h)) for h (M, D), norm_w (D,),
// w13 (D, 2F), w2 (F, D), all bf16. Scratch: xn_t (D, M) and a_t (F, M)
// bf16, part (splits, M, D) f32. 1 <= M <= 8; D a multiple of 8 and F of 4.
PREGO_EXPORT int prego_fused_ffn_block(const void* h, const void* norm_w, const void* w13,
                                       const void* w2, void* xn_t, void* a_t, void* part,
                                       void* out, int M, int D, int F, int splits, float eps,
                                       void* stream) {
    const Args a{h, norm_w, w13, nullptr, w2, nullptr, xn_t, a_t, part, out, D, F, splits, eps};
    return dispatch<true, __nv_bfloat16>(a, M, stream);
}

// K7q: out (M, D) bf16 = h + FFN(rms_norm(h)) for h (M, D) and norm_w (D,)
// bf16, w13 (D, 2F) and w2 (F, D) int8 with f32 column scales s13 (2F,) and
// s2 (D,). Scratch and bounds as K7a's.
PREGO_EXPORT int prego_fused_ffn_block_q8(const void* h, const void* norm_w, const void* w13,
                                          const void* s13, const void* w2, const void* s2,
                                          void* xn_t, void* a_t, void* part, void* out, int M,
                                          int D, int F, int splits, float eps, void* stream) {
    const Args a{h, norm_w, w13, static_cast<const float*>(s13), w2,
                 static_cast<const float*>(s2), xn_t, a_t, part, out, D, F, splits, eps};
    return dispatch<true, int8_t>(a, M, stream);
}

// K7: out (M, D) f32 = silu(x.W1) * (x.W3) . W2 for x (M, D), w13 (D, 2F),
// w2 (F, D), all bf16. Scratch: a_t (F, M) bf16, part (splits, M, D) f32.
// The bounds of K7a's.
PREGO_EXPORT int prego_fused_ffn(const void* x, const void* w13, const void* w2, void* a_t,
                                 void* part, void* out, int M, int D, int F, int splits,
                                 void* stream) {
    const Args a{x, nullptr, w13, nullptr, w2, nullptr, nullptr, a_t, part, out, D, F, splits,
                 0.f};
    return dispatch<false, __nv_bfloat16>(a, M, stream);
}
