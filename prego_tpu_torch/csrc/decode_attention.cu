// K2: bounded single-token GQA decode attention on Hopper.
//
// Replaces prego_tpu/ops/decode_attention.py::decode_attention_bounded and
// its three Pallas bodies (_decode_kernel_bounded + _bounded_walk,
// _decode_kernel_bounded_fold, _decode_kernel_bounded_fold_flat +
// _flat_group_update). Those are TPU scheduling variants of one function:
// for each row b and kv head g, the R query rows of q[b, g] attend over
// cache positions t < valid[b] with a softmax, reading only the blocks
// that hold valid positions. Semantics kept from the Pallas bodies:
// masked positions contribute nothing; valid == 0 gives zeros, not NaN;
// p is cast to the cache dtype before the PV product while the normaliser
// l sums the f32 p; the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it here: one decode step reads K and V once (2 x B x KV x
// valid x hd bf16; 8 MB per layer at B = 8, 32 heads, 512 positions) and
// does 4 FLOPs per element read: far below the card's compute-to-bytes
// ratio, so it is memory bound and the work is to keep enough bytes in
// flight. With B x KV = 256 (b, g) pairs at the 7B shape, one block per
// pair would leave the walk over T serial inside each block.
//
// Design: split-K flash decoding (decode_split.cuh): pass 1 walks each
// live 64-position split of each (b, g); pass 2 merges the live splits of
// each (b, g) with the log-sum-exp rule and writes the bf16 output. A block
// is a short chain of dependent loads (q, then keys, then values), and
// every load of a phase is issued before the first is needed: with the
// decode shapes' few blocks, per-block latency, not bandwidth, sets the
// time.
#include "decode_split.cuh"

namespace {

using namespace decode_split;

__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ valid, __nv_bfloat16* __restrict__ out,  // (B, KV, R, hd)
    int KV, int R, int T, int hd, int NS) {
    const int g = blockIdx.x, b = blockIdx.y;
    const int live = live_splits(valid[b], T);  // 0 when valid == 0 -> zeros
    const size_t bg = static_cast<size_t>(b) * KV + g;
    for (int r = 0; r < R; ++r) {
        const float2 stats = merge_stats(part_ml, bg, r, R, NS, live);
        for (int d = threadIdx.x; d < hd; d += kThreads)
            out[(bg * R + r) * hd + d] =
                merge_value(part_acc, part_ml, bg, r, d, R, hd, NS, live, stats);
    }
}

}  // namespace

PREGO_EXPORT int prego_decode_attention_splits(int T) { return num_splits(T); }

// out (B, KV, R, hd) bf16 from q (B, KV, R, hd), cache k/v (B, KV, T, hd)
// bf16 and valid (B,) int32 on the device. part_acc (B, KV, NS, R, hd) and
// part_ml (B, KV, NS, R, 2) are f32 scratch, NS = ceil(T / 64).
PREGO_EXPORT int prego_decode_attention(const void* q, const void* k, const void* v,
                                        const void* valid, void* out, void* part_acc,
                                        void* part_ml, int B, int KV, int R, int T, int hd,
                                        void* stream) {
    if (B <= 0 || KV <= 0 || R <= 0 || R > kMaxR || T <= 0 || hd <= 0 || hd > kMaxHd ||
        hd % 16 != 0)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int NS = num_splits(T);
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    split_kernel<false><<<dim3(NS, KV, B), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
        static_cast<float*>(part_acc), static_cast<float*>(part_ml), KV, R, T, hd, NS, scale,
        NewKV{nullptr, nullptr, 0, 0}, nullptr, nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine_kernel<<<dim3(KV, B), kThreads, 0, s>>>(
        static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
        static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(out), KV, R, T, hd, NS);
    return cudaGetLastError();
}
