// K4 and K5: the int8 serving matmuls on Hopper.
//
// Replace prego_tpu/ops/quant.py::int8_matmul (quant.py:80, Pallas body
// _int8_matmul_kernel) and ::int8xint8_matmul (quant.py:169,
// _int8xint8_matmul_kernel):
//   K4  y (M, N) f32 = (bf16(x) . bf16(q)) * s       x (M, K) bf16
//   K5  y (M, N) f32 = float(xq . q) * x_s * s       xq (M, K) int8, x_s (M,) f32
// with q (K, N) int8 stored row-major and s (N,) f32, one scale per output
// channel. K4's products of a bf16 and an int8 value are exact in f32 and
// summed in f32; K5 sums its int8 products exactly in int32 and rounds the
// sum once to f32, then multiplies by x_s and s in that order (the JAX
// order), so it gives its plain version's bits.
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
// K5's is in w8a8_matmul.cuh: at M <= 8 a __dp4a GEMV in K4's layout whose
// splits of K meet in a persistent int32 workspace through atomics, the
// last split of a column tile scaling and writing out (one launch, the
// workspace left zero); above, an int8 wgmma kernel fed by TMA, each weight
// tile transposed to K-major in shared memory.
#include <stdint.h>

#include "common.cuh"
#include "w8_matmul.cuh"
#include "w8a8_matmul.cuh"

// Splits of K for the streaming path (M <= 8); 0 selects the tile path.
// K4 sums its splits in a cluster, so takes at most w8::kMaxClusterSplits.
PREGO_EXPORT int prego_int8_matmul_splits(int M, int K, int N) {
    return M > w8::kMaxM ? 0 : w8::num_splits(K, N, w8::kMaxClusterSplits);
}

// K5's splits (M <= 8), their int32 sums meeting in the workspace; 0
// selects the tile path.
PREGO_EXPORT int prego_int8xint8_matmul_splits(int M, int K, int N) {
    return M > w8a8::kMaxM ? 0 : w8::num_splits(K, N);
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
// * s (N,), one launch. splits = prego_int8xint8_matmul_splits (0: the
// tile path). Where splits > 0, ws is an int32 workspace of at least M x N
// and tickets one of at least ceil(N / 128), both zero, and left zero; the
// tile path reads neither. K a multiple of 16, N of 8.
PREGO_EXPORT int prego_int8xint8_matmul(const void* xq, const void* x_scale, const void* q,
                                        const void* s, void* ws, void* tickets, void* out, int M,
                                        int K, int N, int splits, void* stream) {
    if (M < 1 || K < 16 || N < 8 || K % 16 != 0 || N % 8 != 0 ||
        splits != prego_int8xint8_matmul_splits(M, K, N))
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (splits == 0) return w8a8::launch_tile(xq, x_scale, q, s, out, M, K, N, st);
    if (ws == nullptr || tickets == nullptr) return PREGO_BAD_ARGUMENT;
    return w8a8::launch_gemv(xq, x_scale, q, s, out, ws, tickets, M, K, N, splits, st);
}
