// K4's wgmma tile kernel (prego_tpu_torch/csrc/w8_matmul.cuh) at a row
// tile chosen by the caller: 64 x warpgroups rows, 2 or 4. It measures the
// row tiles between which w8::launch_tile chooses; tools/kernel_ab.py
// builds and times it. No path of the port calls it.
#include "../prego_tpu_torch/csrc/w8_matmul.cuh"

PREGO_EXPORT int prego_w8_tile_rows(const void* x, const void* q, const void* s, void* out, int M,
                                    int K, int N, int warpgroups, void* stream) {
    if (M < 1 || K < 8 || N < 8 || K % 8 != 0 || N % 8 != 0) return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (warpgroups == 2) return w8::launch_wgmma<2>(x, q, s, out, M, K, N, st);
    if (warpgroups == 4) return w8::launch_wgmma<4>(x, q, s, out, M, K, N, st);
    return PREGO_BAD_ARGUMENT;
}
