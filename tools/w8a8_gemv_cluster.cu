// K5's streaming GEMV (prego_tpu_torch/csrc/w8a8_matmul.cuh) with its
// splits of K summed in a thread block cluster, as K4's GEMV sums them
// (w8::launch_gemv_cluster), instead of through the workspace's atomics:
// the S <= 16 splits of a column tile run as one cluster, each keeps its
// (M, 128) int32 sums in shared memory, and after a cluster barrier each
// rank sums an equal slice over the ranks through distributed shared
// memory, scales and writes out. One launch, no workspace. It measures the
// design K5's GEMV was chosen against; tools/kernel_ab.py builds and times
// it. No path of the port calls it.
#include <cooperative_groups.h>

#include "../prego_tpu_torch/csrc/w8a8_matmul.cuh"

// a named namespace: an unnamed one here would share its name with the
// header's and make the kernel's registration ambiguous
namespace k5_cluster {

constexpr int kThreads = w8a8::kThreads;
constexpr int kChunk = w8a8::kChunk;
constexpr int kRowGroups = w8a8::kRowGroups;
constexpr int kTileN = w8a8::kTileN;

template <int M>
__global__ void __launch_bounds__(kThreads) w8a8_gemv_cluster_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
    const int8_t* __restrict__ q, const float* __restrict__ scale, float* __restrict__ out,
    int K, int N, int rows_per_split) {
    __shared__ int xs[kChunk / 4][M];
    __shared__ int red[kRowGroups / 2][M][kTileN];
    __shared__ int mine[M * kTileN];  // this split's (M, 128) sums
    w8a8::gemv_partial<M>(xq, q, K, N, rows_per_split, xs, red);
    __syncthreads();
    const int tid = threadIdx.x, n0 = blockIdx.x * kTileN;
    for (int i = tid; i < M * kTileN; i += kThreads) {
        int y = 0;
#pragma unroll
        for (int w = 0; w < kRowGroups / 2; ++w) y += red[w][i / kTileN][i % kTileN];
        mine[i] = y;
    }
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    cluster.sync();
    const int S = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int per = (M * kTileN + S - 1) / S;
    const int i1 = min(M * kTileN, (rank + 1) * per);
    for (int i = rank * per + tid; i < i1; i += kThreads) {
        const int m = i / kTileN, c = i % kTileN;
        if (n0 + c >= N) continue;
        int y = 0;
        for (int r0 = 0; r0 < S; r0 += 8) {
            int v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (r0 + j < S) v[j] = cluster.map_shared_rank(mine, r0 + j)[i];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (r0 + j < S) y += v[j];
        }
        out[static_cast<size_t>(m) * N + n0 + c] =
            static_cast<float>(y) * x_scale[m] * scale[n0 + c];
    }
    cluster.sync();  // no rank's shared memory goes while a peer reads it
}

template <int M>
struct GemvCluster {
    static cudaError_t run(dim3 grid, cudaStream_t s, const void* xq, const void* x_scale,
                           const void* q, const void* scale, void* out, int K, int N, int rows) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            w8a8_gemv_cluster_kernel<M>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (attr != cudaSuccess) return attr;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(kThreads);
        cfg.stream = s;
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = 1;
        at[0].val.clusterDim.y = grid.y;
        at[0].val.clusterDim.z = 1;
        cfg.attrs = at;
        cfg.numAttrs = 1;
        const cudaError_t err = cudaLaunchKernelEx(
            &cfg, w8a8_gemv_cluster_kernel<M>, static_cast<const int8_t*>(xq),
            static_cast<const float*>(x_scale), static_cast<const int8_t*>(q),
            static_cast<const float*>(scale), static_cast<float*>(out), K, N, rows);
        return err != cudaSuccess ? err : cudaGetLastError();
    }
};

}  // namespace k5_cluster

// out (M, N) f32 = f32(xq (M, K) int8 . q (K, N) int8) * x_scale * s, 1 <=
// M <= 8, the splits of K (at most 16) summed in a cluster.
PREGO_EXPORT int prego_w8a8_gemv_cluster(const void* xq, const void* x_scale, const void* q,
                                         const void* s, void* out, int M, int K, int N,
                                         void* stream) {
    if (M < 1 || M > w8a8::kMaxM || K < 16 || N < 8 || K % 16 != 0 || N % 8 != 0)
        return PREGO_BAD_ARGUMENT;
    const int splits = w8::num_splits(K, N, w8::kMaxClusterSplits);
    const dim3 grid((N + k5_cluster::kTileN - 1) / k5_cluster::kTileN, splits);
    return w8::dispatch_m<k5_cluster::GemvCluster>(M, grid, static_cast<cudaStream_t>(stream), xq,
                                                   x_scale, q, s, out, K, N,
                                                   w8::split_rows(K, splits));
}
