// K9: the int8-weight projection with an rms_norm prologue or a residual
// epilogue, on Hopper.
//
// Replaces prego_tpu/ops/fused_dense.py::fused_dense_q8 (Pallas bodies
// _norm_kernel and _res_kernel). For x (M, K) bf16, q (K, N) int8 and one
// f32 scale per column s (N,):
//   norm mode      out = cast(rms_norm(x, norm_w) . q * s)   bf16 or f32 out
//   residual mode  out = residual + bf16(x . q * s)          bf16 out
// with rms_norm's dtype walk (rms_norm.cuh) and K4's product (bf16 x int8
// products exact in f32, f32 sums, the scale after the sum).
//
// What bounds it here: at decode (M = batch <= 8) every weight byte is used
// M times, so the call streams the int8 weights once: K N bytes (the 7B
// qkv 50.3 MB, wo 16.8 MB, lm-head 131 MB; 15.0, 5.0 and 39.1 us at 3.35
// TB/s), and on the host by its launches: a 7B int8 decode step with the
// fusion stack makes 65 K9 calls. The TPU kernel keeps the normed rows
// resident in VMEM across a sequential grid over N tiles; here the blocks
// run in parallel. Above 8 rows (a prefill of up to 64 rows reaches the
// lm-head's K9) the products bound it, on the tensor cores.
//
// Design at M <= 8: the GEMV, then the reduce. A call allocates only its
// output: the partial sums and xn live in a persistent workspace.
//   GEMV: K4's streaming loop: a block owns 128 output columns and one
//     split of K (about 4 blocks an SM) and writes its (M, 128) partial sums
//     into the workspace (S, M, N) f32. Residual mode, and norm mode at the
//     row counts where nothing below won, run the GEMV that K9 had before
//     (w8::launch_gemv, after a norm launch in norm mode). In norm mode, at
//     the row counts kNormGemv marks kFold, the GEMV takes the norm into its
//     prologue: it first sends its split's first kPrefetchRows weight rows
//     into L2 (prefetches that hold no registers), computes 1 / rms of its M
//     rows as the norm launch does (rms_norm.cuh::inv_rms_rows: M K bf16
//     from L2 a block) and stages the normed values in place of x. Where it
//     marks kDependent the norm launch writes xn and the GEMV is launched as
//     its programmatic dependent (hopper::launch_dependent): its blocks
//     start beside the norm's, prefetch, and wait for xn
//     (hopper::wait_prerequisite).
//   reduce: each output's S partials summed in split order, the scale, the
//     cast or the residual sum; a plain launch (as its dependent it would
//     have nothing to do before its wait).
// Which GEMV runs at which row count is what the card measured for each
// (PERF.md), and the code ptxas makes for each row count's loop sets it
// more than the overlap does: the fold won at 1, 2 and 6 rows and lost at
// 7 and 8 (38 MB of rows from L2 at the 7B qkv beside 50 MB of weights);
// the dependent launch won at 3, 5 and 8 rows and lost 0.5-3% at 4, 6 and
// 7. K9's own loop is a copy of K4's (gemv_partial below): sharing one loop
// through a functor changed the code ptxas made for K4's kernels and cost
// K4 4-18% at one row. A one-launch GEMV whose last split of a tile
// reduced (a ticket) lost device time: each block's release before its
// ticket waits for its partial sums to land while the card streams
// weights. No float atomics: the same bits every run, and those of a norm,
// a GEMV and a reduce in three launches, whichever the path.
// Above 8 rows: K4's wgmma tiles (scaled y in f32), after the norm launch
// in norm mode, and the reduce (one split, no scale) that casts or adds the
// residual, with xn and the scaled y in the workspace.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "rms_norm.cuh"
#include "w8_matmul.cuh"

namespace {

constexpr int kThreads = w8::kThreads;
constexpr int kTileN = w8::kTileN;
static_assert(kThreads == rms_norm::kThreads, "the prologue takes rms_norm's block of threads");
// norm mode's GEMV at each row count M <= 8 (kNormGemv[M]): the norm in
// its prologue (kFold), or a norm launch first with the GEMV as its
// programmatic dependent (kDependent) or plainly after it, the GEMV K9 had
// before (kAfterNorm). A folded or dependent GEMV block first sends
// kPrefetchRows of its split's weight rows into L2.
enum class NormGemvAt { kFold, kDependent, kAfterNorm };
constexpr NormGemvAt kNormGemv[w8::kMaxM + 1] = {
    NormGemvAt::kAfterNorm,                          // (no rows)
    NormGemvAt::kFold,      NormGemvAt::kFold,       // 1, 2
    NormGemvAt::kDependent, NormGemvAt::kAfterNorm,  // 3, 4
    NormGemvAt::kDependent, NormGemvAt::kFold,       // 5, 6
    NormGemvAt::kAfterNorm, NormGemvAt::kDependent,  // 7, 8
};
constexpr int kPrefetchRows = 64;
static_assert(kPrefetchRows <= w8::kChunk, "the prefetch covers the first chunk at most");

// x (M, K) bf16 as the streaming loop stages it: each value in f32
struct PlainRows {
    const __nv_bfloat16* x;
    __device__ __forceinline__ float operator()(int m, int k, int K) const {
        return bf2f(x[static_cast<size_t>(m) * K + k]);
    }
};

// x's rows as the norm launch writes them
struct NormedRows {
    const __nv_bfloat16* x;
    const __nv_bfloat16* norm_w;
    const float* inv_rms;  // (M,), shared memory
    __device__ __forceinline__ float operator()(int m, int k, int K) const {
        return rms_norm::normed(x, norm_w, inv_rms[m], m, k, K);
    }
};

// This block's (M, 128) f32 partial sums of x (M, K) . q (K, N) int8 over
// the split blockIdx.y's rows, into red (the two row groups of a warp
// joined, the warps still apart): w8_gemv_kernel's loop, with x's value at
// (m, k) as rows(m, k, K) stages it. The caller sums red's kRowGroups / 2
// warps in order after a barrier.
template <int M, typename Rows>
__device__ __forceinline__ void gemv_partial(const Rows& rows, const int8_t* __restrict__ q,
                                             int K, int N, int rows_per_split,
                                             float (*xs)[M], float (*red)[M][kTileN]) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cg = tid % w8::kColGroups, rg = tid / w8::kColGroups;
    const int n = blockIdx.x * kTileN + cg * w8::kCols;
    const int kb = blockIdx.y * rows_per_split, ke = min(K, kb + rows_per_split);
    float acc[M][w8::kCols];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < w8::kCols; ++j) acc[m][j] = 0.f;
    for (int c0 = kb; c0 < ke; c0 += w8::kChunk) {
        const int clen = min(w8::kChunk, ke - c0);
        __syncthreads();  // the previous chunk's readers are done
        for (int i = tid; i < M * clen; i += kThreads) {
            const int m = i / clen, kk = i % clen;
            xs[kk][m] = rows(m, c0 + kk, K);
        }
        __syncthreads();
        if (n < N) {
            const int8_t* qc = q + static_cast<size_t>(c0) * N + n;
#pragma unroll 4
            for (int kk = rg; kk < clen; kk += w8::kRowGroups) {
                const uint2 raw = *reinterpret_cast<const uint2*>(qc + static_cast<size_t>(kk) * N);
                float w[w8::kCols];
                int8x4_to_float(raw.x, w);
                int8x4_to_float(raw.y, w + 4);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const float xv = xs[kk][m];
#pragma unroll
                    for (int j = 0; j < w8::kCols; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
                }
            }
        }
    }
    // the two row groups of a warp (lanes 0-15, 16-31); the warps stay apart
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int j = 0; j < w8::kCols; ++j)
            acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if (lane < 16) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < w8::kCols; ++j) red[warp][m][cg * w8::kCols + j] = acc[m][j];
    }
}

// Norm mode's GEMV: grid (ceil(N / 128), S) over (M, N); part[split] (M,
// N) = the split's unscaled partial sums of rms_norm(x) . q, normed on the
// way in (kDependent false) or read from xn, which the norm launch before
// this one writes (kDependent, its programmatic dependent)
template <int M, bool kDependent>
__global__ void __launch_bounds__(kThreads) dense_q8_norm_gemv_kernel(
    const __nv_bfloat16* x,                    // (M, K): x, or kDependent xn, read after the wait
    const __nv_bfloat16* __restrict__ norm_w,  // (K,), !kDependent
    const int8_t* __restrict__ q,              // (K, N)
    float* __restrict__ part,                  // (S, M, N)
    int K, int N, int rows_per_split, float eps) {
    __shared__ float xs[w8::kChunk][M];
    __shared__ float red[w8::kRowGroups / 2][M][kTileN];
    const int tid = threadIdx.x, n0 = blockIdx.x * kTileN;
    // the split's first weight rows into L2 while the norm is taken: each
    // thread the 8 bytes it reads first, every 16th row
    const int n = n0 + (tid % w8::kColGroups) * w8::kCols;
    const int kb = blockIdx.y * rows_per_split;
    const int ke = min(K, kb + min(rows_per_split, kPrefetchRows));
    if (n < N)
        for (int k = kb + tid / w8::kColGroups; k < ke; k += w8::kRowGroups)
            hopper::prefetch_l2(q + static_cast<size_t>(k) * N + n);
    if constexpr (!kDependent) {
        __shared__ float warp_part[M][rms_norm::kWarps];
        __shared__ float inv_rms[M];
        rms_norm::inv_rms_rows<M>(x, K, eps, warp_part, inv_rms);
        gemv_partial<M>(NormedRows{x, norm_w, inv_rms}, q, K, N, rows_per_split, xs, red);
    } else {
        hopper::wait_prerequisite();  // xn is written and visible
        gemv_partial<M>(PlainRows{x}, q, K, N, rows_per_split, xs, red);
    }
    __syncthreads();
    for (int i = tid; i < M * kTileN; i += kThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        float y = 0.f;
#pragma unroll
        for (int w = 0; w < w8::kRowGroups / 2; ++w) y += red[w][m][c];
        part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n0 + c] = y;
    }
}

template <int M>
struct NormGemv {
    static cudaError_t run(dim3 grid, cudaStream_t st, bool dependent, const void* x,
                           const void* norm_w, void* part, const void* q, int K, int N,
                           int rows_per_split, float eps) {
        const auto* xb = static_cast<const __nv_bfloat16*>(x);
        const auto* wb = static_cast<const __nv_bfloat16*>(norm_w);
        const auto* qb = static_cast<const int8_t*>(q);
        auto* pf = static_cast<float*>(part);
        if (dependent)
            return hopper::launch_dependent(dense_q8_norm_gemv_kernel<M, true>, grid,
                                            dim3(kThreads), st, xb, wb, qb, pf, K, N,
                                            rows_per_split, eps);
        dense_q8_norm_gemv_kernel<M, false><<<grid, kThreads, 0, st>>>(
            xb, wb, qb, pf, K, N, rows_per_split, eps);
        return cudaGetLastError();
    }
};

// The last launch: y = the S splits of part (S, M, N) summed in order,
// times s unless s is null; then (kResidual) bf16(residual + bf16(y)), or y
// cast to Out. One thread an output.
template <bool kResidual, typename Out>
__global__ void __launch_bounds__(kThreads) dense_q8_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ scale,  // scale (N,) or null
    const __nv_bfloat16* __restrict__ residual,                       // (M, N), kResidual only
    Out* __restrict__ out, int MN, int N, int S) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= MN) return;
    float y = 0.f;
    for (int s = 0; s < S; ++s) y += part[static_cast<size_t>(s) * MN + i];
    if (scale != nullptr) y *= scale[i % N];
    if constexpr (kResidual)
        out[i] = f2bf(bf2f(residual[i]) + round_bf16(y));
    else if constexpr (sizeof(Out) == 2)
        out[i] = f2bf(y);
    else
        out[i] = y;
}

template <bool kResidual, typename Out>
cudaError_t reduce(const void* part, const void* s, const void* residual, void* out, int MN,
                   int N, int S, cudaStream_t st) {
    dense_q8_reduce_kernel<kResidual, Out><<<(MN + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(s),
        static_cast<const __nv_bfloat16*>(residual), static_cast<Out*>(out), MN, N, S);
    return cudaGetLastError();
}

}  // namespace

// Splits of K of the streaming path (M <= 8), for the wrapper's workspace;
// 0 selects the tile path (M > 8).
PREGO_EXPORT int prego_fused_dense_q8_splits(int M, int K, int N) {
    return M > w8::kMaxM ? 0 : w8::num_splits(K, N);
}

// K9: out (M, N) from x (M, K) bf16, q (K, N) int8, s (N,) f32, with either
// norm_w (K,) bf16 (norm mode: out bf16 if out_bf16 else f32) or residual
// (M, N) bf16 (residual mode: out bf16). splits =
// prego_fused_dense_q8_splits. Workspace: part f32, (splits, M, N) on the
// streaming path (splits > 0), (M, N) on the tile path unless the out is
// f32 (norm mode); xn bf16 (M, K) in norm mode (unused where the GEMV
// takes the norm). Pointers the call does not use may be null. M >= 1; K and N
// multiples of 8.
PREGO_EXPORT int prego_fused_dense_q8(const void* x, const void* norm_w, const void* residual,
                                      const void* q, const void* s, void* xn, void* part,
                                      void* out, int M, int K, int N, int splits, int out_bf16,
                                      float eps, void* stream) {
    const bool norm = norm_w != nullptr;
    const bool tiles = splits == 0, direct = tiles && norm && !out_bf16;
    const NormGemvAt at = norm && !tiles ? kNormGemv[M] : NormGemvAt::kAfterNorm;
    const bool fold = at == NormGemvAt::kFold, dependent = at == NormGemvAt::kDependent;
    if (M < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0 ||
        splits != prego_fused_dense_q8_splits(M, K, N) || norm == (residual != nullptr) ||
        (!norm && !out_bf16) || (norm && !fold && xn == nullptr) || (!direct && part == nullptr))
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (norm && !fold) {
        err = rms_norm::launch<false>(x, norm_w, xn, M, K, eps, st);
        if (err != cudaSuccess) return err;
    }
    const void* a = norm && !fold ? xn : x;
    if (tiles) {  // y scaled in f32, into out when that is f32
        err = w8::launch_tile(a, q, s, direct ? out : part, M, K, N, st);
        if (direct) return err;
        s = nullptr;  // applied
        splits = 1;
    } else if (fold || dependent) {
        const dim3 grid((N + kTileN - 1) / kTileN, splits);
        err = w8::dispatch_m<NormGemv>(M, grid, st, dependent, a, norm_w, part, q, K, N,
                                       w8::split_rows(K, splits), eps);
    } else {
        err = w8::launch_gemv(a, q, part, M, K, N, splits, st);
    }
    if (err != cudaSuccess) return err;
    if (!norm) return reduce<true, __nv_bfloat16>(part, s, residual, out, M * N, N, splits, st);
    if (out_bf16) return reduce<false, __nv_bfloat16>(part, s, nullptr, out, M * N, N, splits, st);
    return reduce<false, float>(part, s, nullptr, out, M * N, N, splits, st);
}
