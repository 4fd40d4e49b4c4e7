// Hopper's asynchronous copy and barrier primitives, as inline PTX, for
// the kernels that use them (K2 in decode_attention.cu, K4 in
// w8_matmul.cuh, K7q in fused_ffn_q8.cu, K1 in gru.cu): mbarriers, bulk
// copies (also multicast into a cluster) and tensor (TMA) copies, cp.async with
// an mbarrier arrival, the async-proxy fence, named barriers, and wgmma's
// shared-memory descriptors and fences; programmatic dependent launch and
// an L2 prefetch (K8 in decode_attention_wo.cu, K9 in fused_dense_q8.cu);
// and the device's SM count, which sizes their grids; on the host, the
// driver's tensor-map encoder and a kernel's dynamic shared memory allowance
// (K4, K5, K7q and K7). Addresses of shared memory are 32-bit shared-window
// addresses (smem_u32).
#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {
// Internal linkage, as in w8_matmul.cuh: each library keeps its own copy,
// num_sms's static included
namespace {

// The current device's SM count, read once
inline int num_sms() {
    static const int n = [] {
        int dev = 0, count = 132;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        return count;
    }();
    return n;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime: no
// link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// the dynamic shared memory a kernel may have: the card's opt-in limit less
// its static shared memory, allowed; negative if that failed
template <typename Kernel>
int allow_smem(Kernel kernel) {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaFuncGetAttributes(&fa, kernel) != cudaSuccess)
        return -1;
    const int bytes = optin - static_cast<int>(fa.sharedSizeBytes);
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) ==
                   cudaSuccess
               ? bytes : -1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy and the cluster
__device__ __forceinline__ void fence_mbarrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// `bytes` (a multiple of 16) from global memory into the shared memory of
// every CTA of the cluster named in `mask`, at the same offset `dst` in each,
// each copy completing on that CTA's own barrier at `bar` (K1 in gru.cu)
__device__ __forceinline__ void bulk_load_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
}

// the box of a 2-d tensor map at (c0 innermost, c1), completing on `bar`;
// the map must live in parameter, constant or global memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap, int c0, int c1,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// cp.async of 8 bytes; src_bytes 0 writes zeros (src must still be a
// valid address)
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src, uint32_t src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

// one arrival on `bar` when this thread's earlier cp.asyncs have landed,
// counted against the barrier's expected arrivals
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over `threads` threads (whole warps) under id `id` (1-15)
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch. A kernel launched by launch_dependent may
// start once every block of the kernel before it on the stream has called
// launch_dependents() or exited, so that its blocks run beside that
// kernel's tail; its wait_prerequisite() returns once that kernel has
// completed and its memory operations are visible. Work before the wait
// must not read what that kernel writes.
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisite() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the 128-byte line holding p on its way into L2, no register held
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// kernel<<<grid, block, 0, stream>>>(args...) as a programmatic dependent
// of the stream's previous kernel; no other launch is tried if it fails
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.stream = stream;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// A wgmma shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets (each a multiple of 16)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
           (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

}  // namespace
}  // namespace hopper
