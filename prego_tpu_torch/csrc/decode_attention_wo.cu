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
// Design: one exported C entry point issues three launches, so the host
// makes one call per layer where the unfused path makes four (K2, the wo
// product, the cast and the add), which is what counts on a host-bound
// decode step.
//   1. pass 1 of split-K flash decoding (decode_split.cuh);
//   2. merge + project (grid D / 64 x H heads): a block first issues its
//      loads of head h's hd rows of wo for its 64 columns (registers), then
//      merges head h's live splits for every row b into o (bf16 values, in
//      shared memory) while those loads are in flight, then sums o . wo
//      over its rows: f32 partials (H, B, D). Every column block repeats
//      the small merge of its head (B x live x hd f32 reads from L2); that
//      costs less than the launch a separate merge pass would add, and it
//      keeps o out of device memory.
//   3. reduce (one thread per output): the H partials summed in head
//      order, written as f32 or as h + bf16(sum).
// No float atomics: two runs give the same bits.
#include "decode_split.cuh"

namespace {

using namespace decode_split;

constexpr int kProjThreads = 256;
constexpr int kProjWarps = kProjThreads / 32;
constexpr int kProjCols = 64;                    // output columns per block: 16 threads x 4
constexpr int kRowGroups = kProjThreads / 16;    // threads over a head's rows
constexpr int kRowsPerThread = kMaxHd / kRowGroups;
constexpr int kMaxB = 8;

template <int B>
__global__ void __launch_bounds__(kProjThreads) merge_project_kernel(
    const float* __restrict__ part_acc,  // (B, KV, NS, R, hd)
    const float* __restrict__ part_ml,   // (B, KV, NS, R, 2)
    const int* __restrict__ valid,       // (B,): the bound is valid + valid_add
    int valid_add,
    const __nv_bfloat16* __restrict__ wo,  // (H * hd, D)
    float* __restrict__ part,              // (H, B, D)
    int KV, int R, int T, int hd, int NS, int D) {
    __shared__ float o_s[B][kMaxHd];
    __shared__ float2 stats_s[B];
    __shared__ float red[kProjWarps][B][kProjCols];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int d0 = blockIdx.x * kProjCols, h = blockIdx.y;
    const int g = h / R, r = h % R;
    const int cq = tid % 16, kg = tid / 16;
    const int d = d0 + cq * 4;

    // this thread's 4 columns of head h's rows kg, kg + 16, ... of wo,
    // issued before the merge so that they are in flight during it
    uint2 w[kRowsPerThread];
    const __nv_bfloat16* wcol = wo + static_cast<size_t>(h) * hd * D + d;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
        const int k = kg + i * kRowGroups;
        w[i] = (d < D && k < hd) ? *reinterpret_cast<const uint2*>(wcol + static_cast<size_t>(k) * D)
                                 : make_uint2(0u, 0u);
    }

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
    for (int i = 0; i < kRowsPerThread; ++i) {
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
}

// out = the H head partials summed in order: f32, or h + bf16(sum) (kRes)
template <bool kRes>
__global__ void __launch_bounds__(kProjThreads) wo_reduce_kernel(
    const float* __restrict__ part, const __nv_bfloat16* __restrict__ h,
    void* __restrict__ out, int BD, int H) {
    const int i = blockIdx.x * kProjThreads + threadIdx.x;
    if (i >= BD) return;
    float y = 0.f;
    for (int s = 0; s < H; ++s) y += part[static_cast<size_t>(s) * BD + i];
    if constexpr (kRes)
        static_cast<__nv_bfloat16*>(out)[i] = f2bf(bf2f(h[i]) + round_bf16(y));
    else
        static_cast<float*>(out)[i] = y;
}

template <int B>
cudaError_t launch_project(const void* part_acc, const void* part_ml, const void* valid,
                           int valid_add, const void* wo, void* part, int KV, int R, int T,
                           int hd, int NS, int D, cudaStream_t s) {
    merge_project_kernel<B><<<dim3((D + kProjCols - 1) / kProjCols, KV * R), kProjThreads, 0, s>>>(
        static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
        static_cast<const int*>(valid), valid_add, static_cast<const __nv_bfloat16*>(wo),
        static_cast<float*>(part), KV, R, T, hd, NS, D);
    return cudaGetLastError();
}

// the three launches; `upd` takes the bound as pos (valid = pos + 1) and
// writes k_new / v_new into the cache first
int run(const void* q, const void* k, const void* v, const void* valid, bool upd, NewKV nkv,
        const void* wo, const void* residual, void* out, void* part_acc, void* part_ml,
        void* part, int B, int KV, int R, int T, int hd, int D, void* stream) {
    if (B < 1 || B > kMaxB || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 ||
        hd > kMaxHd || hd % 16 != 0 || D <= 0 || D % 8 != 0)
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
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int add = upd ? 1 : 0;
    switch (B) {
        case 1: err = launch_project<1>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 2: err = launch_project<2>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 3: err = launch_project<3>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 4: err = launch_project<4>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 5: err = launch_project<5>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 6: err = launch_project<6>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        case 7: err = launch_project<7>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
        default: err = launch_project<8>(acc, ml, vl, add, wo, part, KV, R, T, hd, NS, D, s); break;
    }
    if (err != cudaSuccess) return err;
    const int BD = B * D;
    const int blocks = (BD + kProjThreads - 1) / kProjThreads;
    const auto* hb = static_cast<const __nv_bfloat16*>(residual);
    if (residual != nullptr)
        wo_reduce_kernel<true><<<blocks, kProjThreads, 0, s>>>(static_cast<const float*>(part),
                                                               hb, out, BD, KV * R);
    else
        wo_reduce_kernel<false><<<blocks, kProjThreads, 0, s>>>(static_cast<const float*>(part),
                                                                nullptr, out, BD, KV * R);
    return cudaGetLastError();
}

}  // namespace

PREGO_EXPORT int prego_decode_attention_wo_splits(int T) { return num_splits(T); }

// K8: out (B, D) = attention(q, k, v; valid) . wo, f32 when residual is
// null, else residual + bf16(.) in bf16. q (B, KV, R, hd), cache k/v
// (B, KV, T, hd), wo (KV R hd, D), residual (B, D), all bf16; valid (B,)
// int32. Scratch: part_acc (B, KV, NS, R, hd) and part_ml (B, KV, NS, R, 2)
// f32 with NS = ceil(T / 64), part (KV R, B, D) f32. 1 <= B <= 8, R <= 8,
// hd a multiple of 16 up to 256, D a multiple of 8.
PREGO_EXPORT int prego_decode_attention_wo(const void* q, const void* k, const void* v,
                                           const void* valid, const void* wo,
                                           const void* residual, void* out, void* part_acc,
                                           void* part_ml, void* part, int B, int KV, int R,
                                           int T, int hd, int D, void* stream) {
    return run(q, k, v, valid, false, NewKV{nullptr, nullptr, 0, 0}, wo, residual, out,
               part_acc, part_ml, part, B, KV, R, T, hd, D, stream);
}

// K8u: writes k_new / v_new ((B, KV, hd) bf16 each, batch strides k_stride
// and v_stride elements, rows 16-byte aligned) into cache row pos[b] in
// place, then out (B, D) bf16 = residual + bf16(attention over positions
// <= pos[b] . wo). pos (B,) int32; the rest as K8's.
PREGO_EXPORT int prego_decode_attention_wo_res_upd(
    const void* q, const void* residual, const void* k_new, const void* v_new, int k_stride,
    int v_stride, void* k, void* v, const void* pos, const void* wo, void* out, void* part_acc,
    void* part_ml, void* part, int B, int KV, int R, int T, int hd, int D, void* stream) {
    if (residual == nullptr || k_stride < KV * hd || v_stride < KV * hd || k_stride % 8 != 0 ||
        v_stride % 8 != 0)
        return PREGO_BAD_ARGUMENT;
    const NewKV nkv{static_cast<const __nv_bfloat16*>(k_new),
                    static_cast<const __nv_bfloat16*>(v_new), k_stride, v_stride};
    return run(q, k, v, pos, true, nkv, wo, residual, out, part_acc, part_ml, part, B, KV, R,
               T, hd, D, stream);
}
