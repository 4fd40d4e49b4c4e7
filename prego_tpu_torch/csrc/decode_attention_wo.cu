// K8 and K8u: bounded decode attention with the output projection fused,
// and optionally the residual add and this token's cache write, on Hopper.
//
// Replaces prego_tpu/ops/decode_attention.py::decode_attention_bounded_wo
// (Pallas bodies _decode_kernel_bounded_wo, _decode_kernel_bounded_wo_res)
// and ::decode_attention_bounded_wo_res_upd (_decode_kernel_bounded_wo_res_upd).
// For each row b, with H = KV x R query heads:
//   o   = bf16(attention of q[b] over positions < valid[b])   K2's output, (H x hd)
//   y   = o . wo                                              wo (H x hd, D) bf16, f32 sums
//   out = y in f32 (K8), or h + bf16(y) in h's dtype (K8 with the residual, K8u)
// K8u first writes this token's k/v into cache row pos = valid - 1 and
// attends over positions <= pos (decode_split.cuh says how). The TPU body
// stages the 8-row tile around pos and writes it back, a Mosaic tiling
// workaround that has no counterpart here: one block writes the one row.
//
// What bounds it here: wo (8.4 MB at the 1B shape, H 16, hd 128, D 2048)
// and the live K/V rows are each read once, for 2 FLOPs a weight element
// a row: at B <= 8 the call is memory bound, like K2 and K7a.
//
// Design: one exported C entry point issues two launches, so the host
// makes one call per layer where the unfused path makes four (K2, the wo
// product, the cast and the add), which is what counts on a host-bound
// decode step.
//   1. pass 1 of split-K flash decoding (decode_split.cuh); each block first
//      lets its programmatic dependent start;
//   2. merge + project (grid D / 64 x H heads), launched as a programmatic
//      dependent of pass 1 (hopper::launch_dependent), so that its blocks
//      start beside pass 1's: a block first issues its loads of head h's hd
//      rows of wo for its 64 columns (registers), and only then waits for
//      pass 1 to end (hopper::wait_prerequisite). So wo, the call's largest
//      read (8.4 MB at the 1B shape against 2.4 MB of K/V at B 1, bound
//      300), streams while the attention runs, and no launch gap separates
//      the two. The block then merges head h's live splits for every row b
//      into o (bf16 values, in shared memory) and sums o . wo over its rows
//      into a (B, 64) partial, which it writes into the workspace (H, B, D).
//      Every column block repeats the small merge of its head (B x live x hd
//      f32 reads from L2); that keeps o out of device memory. Then a ticket
//      on its column tile's counter (one acq_rel atomic by one thread after
//      the block's barrier): the last of the H head blocks of a tile sums
//      the H partials in head order (eight loads in flight at a time),
//      writes f32 or h + bf16(sum), and zeroes the counter, which is so zero
//      between calls.
// The projection blocks that start early hold their wo loads in registers
// and their slots while they wait. A thread holds hd / 16 rows of wo (8
// uint2 at hd 128), so that the 1B shape's 512 projection blocks fit one
// wave at 64 registers a thread. At B 8 (1912 positions) the 512 live
// pass-1 blocks (43 KB of shared memory, 92 registers a thread) are all
// resident before the dependent may start, and the projection blocks fill
// what is left: about one an SM until pass 1's blocks retire.
// No float atomics: two runs give the same bits, and those of a separate
// reduce launch in head order.
#include "decode_split.cuh"
#include "hopper.cuh"

namespace {

using namespace decode_split;

constexpr int kProjThreads = 256;
constexpr int kProjWarps = kProjThreads / 32;
constexpr int kProjCols = 64;                    // output columns per block: 16 threads x 4
constexpr int kRowGroups = kProjThreads / 16;    // threads over a head's rows
constexpr int kMaxB = 8;

// sum_{s < S} p[s * stride] in that order, eight loads in flight at a
// time, so that a sum of values in L2 waits for ceil(S / 8) round trips,
// not S. Loads bypass L1 (__ldcg): other blocks of the same launch wrote
// the values.
__device__ __forceinline__ float sum_in_order(const float* p, size_t stride, int S) {
    float y = 0.f;
    for (int s0 = 0; s0 < S; s0 += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = s0 + j < S ? __ldcg(p + (s0 + j) * stride) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (s0 + j < S) y += v[j];
    }
    return y;
}

// kRows: a thread's rows of wo, hd / 16 rounded up to 4, 8 or 16. Up to hd
// 128 (every model shape) a block fits 64 registers a thread, so that 4 run
// an SM and the 512 blocks of the 1B shape (H 16, D 2048) run in one wave,
// each with its wo loads issued before the wait.
template <int B, int kRows>
__global__ void __launch_bounds__(kProjThreads, kRows <= 8 ? 4 : 2) merge_project_kernel(
    const float* part_acc,               // (B, KV, NS, R, hd), pass 1's: read after the wait
    const float* part_ml,                // (B, KV, NS, R, 2), the same
    const int* __restrict__ valid,       // (B,): the bound is valid + valid_add
    int valid_add,
    const __nv_bfloat16* __restrict__ wo,        // (H * hd, D)
    const __nv_bfloat16* __restrict__ residual,  // (B, D), or null: an f32 out
    void* __restrict__ out,                      // (B, D), bf16 or f32
    float* part,                                 // (H, B, D) workspace
    unsigned int* tickets,                       // (ceil(D / 64),), zero between calls
    int KV, int R, int T, int hd, int NS, int D) {
    __shared__ float o_s[B][kMaxHd];
    __shared__ float2 stats_s[B];
    __shared__ float red[kProjWarps][B][kProjCols];
    __shared__ bool last;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int d0 = blockIdx.x * kProjCols, h = blockIdx.y, H = gridDim.y;
    const int g = h / R, r = h % R;
    const int cq = tid % 16, kg = tid / 16;
    const int d = d0 + cq * 4;

    // this thread's 4 columns of head h's rows kg, kg + 16, ... of wo,
    // issued before the wait so that they are in flight while pass 1 runs
    uint2 w[kRows];
    const __nv_bfloat16* wcol = wo + static_cast<size_t>(h) * hd * D + d;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int k = kg + i * kRowGroups;
        w[i] = (d < D && k < hd) ? *reinterpret_cast<const uint2*>(wcol + static_cast<size_t>(k) * D)
                                 : make_uint2(0u, 0u);
    }
    hopper::wait_prerequisite();  // pass 1 has ended: its partial sums are visible

    if (tid < B) {
        const size_t bg = static_cast<size_t>(tid) * KV + g;
        stats_s[tid] = merge_stats(part_ml, bg, r, R, NS, live_splits(valid[tid] + valid_add, T));
    }
    __syncthreads();
    for (int idx = tid; idx < B * hd; idx += kProjThreads) {
        const int b = idx / hd, k = idx % hd;
        const size_t bg = static_cast<size_t>(b) * KV + g;
        o_s[b][k] = bf2f(merge_value(part_acc, part_ml, bg, r, k, R, hd, NS,
                                     live_splits(valid[b] + valid_add, T), stats_s[b]));
    }
    __syncthreads();

    float acc[B][4];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int k = kg + i * kRowGroups;
        if (k < hd) {
            const float2 w01 = bf16x2_to_float2(w[i].x), w23 = bf16x2_to_float2(w[i].y);
#pragma unroll
            for (int b = 0; b < B; ++b) {
                const float x = o_s[b][k];
                acc[b][0] = fmaf(x, w01.x, acc[b][0]);
                acc[b][1] = fmaf(x, w01.y, acc[b][1]);
                acc[b][2] = fmaf(x, w23.x, acc[b][2]);
                acc[b][3] = fmaf(x, w23.y, acc[b][3]);
            }
        }
    }
    // the two row groups of a warp (lanes 0-15, 16-31), then the 8 warps
    // through shared memory, in warp order
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 16);
    if (lane < 16) {
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j) red[warp][b][cq * 4 + j] = acc[b][j];
    }
    __syncthreads();
    for (int idx = tid; idx < B * kProjCols; idx += kProjThreads) {
        const int b = idx / kProjCols, c = idx % kProjCols;
        if (d0 + c >= D) continue;
        float y = 0.f;
#pragma unroll
        for (int ww = 0; ww < kProjWarps; ++ww) y += red[ww][b][c];
        part[(static_cast<size_t>(h) * B + b) * D + d0 + c] = y;
    }
    __syncthreads();  // the block's partial before thread 0's release
    if (tid == 0) {  // one atomic that releases this head's partial and acquires the others'
        unsigned int prev;
        asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                     : "=r"(prev)
                     : "l"(tickets + blockIdx.x)
                     : "memory");
        last = prev == static_cast<unsigned int>(H - 1);
    }
    __syncthreads();
    if (!last) return;
    // out = the H head partials summed in head order: f32, or h + bf16(sum)
    for (int idx = tid; idx < B * kProjCols; idx += kProjThreads) {
        const int b = idx / kProjCols, c = idx % kProjCols;
        if (d0 + c >= D) continue;
        const size_t i = static_cast<size_t>(b) * D + d0 + c;
        const float y = sum_in_order(part + i, static_cast<size_t>(B) * D, H);
        if (residual != nullptr)
            static_cast<__nv_bfloat16*>(out)[i] = f2bf(bf2f(residual[i]) + round_bf16(y));
        else
            static_cast<float*>(out)[i] = y;
    }
    if (tid == 0) tickets[blockIdx.x] = 0u;
}

template <int B, int kRows>
cudaError_t launch_project(const void* part_acc, const void* part_ml, const void* valid,
                           int valid_add, const void* wo, const void* residual, void* out,
                           void* part, void* tickets, int KV, int R, int T, int hd, int NS,
                           int D, cudaStream_t s) {
    return hopper::launch_dependent(
        merge_project_kernel<B, kRows>, dim3((D + kProjCols - 1) / kProjCols, KV * R),
        dim3(kProjThreads), s, static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<const int*>(valid), valid_add,
        static_cast<const __nv_bfloat16*>(wo), static_cast<const __nv_bfloat16*>(residual), out,
        static_cast<float*>(part), static_cast<unsigned int*>(tickets), KV, R, T, hd, NS, D);
}

template <int B, typename... Args>
cudaError_t launch_project_rows(int hd, Args... args) {
    if (hd <= 4 * kRowGroups) return launch_project<B, 4>(args...);
    if (hd <= 8 * kRowGroups) return launch_project<B, 8>(args...);
    return launch_project<B, 16>(args...);
}

// the two launches; `upd` takes the bound as pos (valid = pos + 1) and
// writes k_new / v_new into the cache first
int run(const void* q, const void* k, const void* v, const void* valid, bool upd, NewKV nkv,
        const void* wo, const void* residual, void* out, void* part_acc, void* part_ml,
        void* part, void* tickets, int B, int KV, int R, int T, int hd, int D, void* stream) {
    if (B < 1 || B > kMaxB || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 ||
        hd > kMaxHd || hd % 16 != 0 || D <= 0 || D % 8 != 0 || tickets == nullptr)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int NS = num_splits(T);
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    const int* vl = static_cast<const int*>(valid);
    float* acc = static_cast<float*>(part_acc);
    float* ml = static_cast<float*>(part_ml);
    if (upd)
        split_kernel<true><<<dim3(NS, KV, B), kThreads, 0, s>>>(
            qb, kb, vb, vl, acc, ml, KV, R, T, hd, NS, scale, nkv,
            const_cast<__nv_bfloat16*>(kb), const_cast<__nv_bfloat16*>(vb));
    else
        split_kernel<false><<<dim3(NS, KV, B), kThreads, 0, s>>>(
            qb, kb, vb, vl, acc, ml, KV, R, T, hd, NS, scale, NewKV{nullptr, nullptr, 0, 0},
            nullptr, nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int add = upd ? 1 : 0;
#define PREGO_PROJECT(NB)                                                                 \
    launch_project_rows<NB>(hd, acc, ml, vl, add, wo, residual, out, part, tickets, KV, R, T, \
                            hd, NS, D, s)
    switch (B) {
        case 1: return PREGO_PROJECT(1);
        case 2: return PREGO_PROJECT(2);
        case 3: return PREGO_PROJECT(3);
        case 4: return PREGO_PROJECT(4);
        case 5: return PREGO_PROJECT(5);
        case 6: return PREGO_PROJECT(6);
        case 7: return PREGO_PROJECT(7);
        default: return PREGO_PROJECT(8);
    }
#undef PREGO_PROJECT
}

}  // namespace

PREGO_EXPORT int prego_decode_attention_wo_splits(int T) { return num_splits(T); }

// K8: out (B, D) = attention(q, k, v; valid) . wo, f32 when residual is
// null, else residual + bf16(.) in bf16. q (B, KV, R, hd), cache k/v
// (B, KV, T, hd), wo (KV R hd, D), residual (B, D), all bf16; valid (B,)
// int32. Workspace: part_acc (B, KV, NS, R, hd) and part_ml (B, KV, NS, R,
// 2) f32 with NS = ceil(T / 64), part (KV R, B, D) f32, tickets
// (ceil(D / 64),) u32 zero (and left zero). 1 <= B <= 8, R <= 8, hd a
// multiple of 16 up to 256, D a multiple of 8.
PREGO_EXPORT int prego_decode_attention_wo(const void* q, const void* k, const void* v,
                                           const void* valid, const void* wo,
                                           const void* residual, void* out, void* part_acc,
                                           void* part_ml, void* part, void* tickets, int B,
                                           int KV, int R, int T, int hd, int D, void* stream) {
    return run(q, k, v, valid, false, NewKV{nullptr, nullptr, 0, 0}, wo, residual, out,
               part_acc, part_ml, part, tickets, B, KV, R, T, hd, D, stream);
}

// K8u: writes k_new / v_new ((B, KV, hd) bf16 each, batch strides k_stride
// and v_stride elements, rows 16-byte aligned) into cache row pos[b] in
// place, then out (B, D) bf16 = residual + bf16(attention over positions
// <= pos[b] . wo). pos (B,) int32; the rest as K8's.
PREGO_EXPORT int prego_decode_attention_wo_res_upd(
    const void* q, const void* residual, const void* k_new, const void* v_new, int k_stride,
    int v_stride, void* k, void* v, const void* pos, const void* wo, void* out, void* part_acc,
    void* part_ml, void* part, void* tickets, int B, int KV, int R, int T, int hd, int D,
    void* stream) {
    if (residual == nullptr || k_stride < KV * hd || v_stride < KV * hd || k_stride % 8 != 0 ||
        v_stride % 8 != 0)
        return PREGO_BAD_ARGUMENT;
    const NewKV nkv{static_cast<const __nv_bfloat16*>(k_new),
                    static_cast<const __nv_bfloat16*>(v_new), k_stride, v_stride};
    return run(q, k, v, pos, true, nkv, wo, residual, out, part_acc, part_ml, part, tickets, B,
               KV, R, T, hd, D, stream);
}
