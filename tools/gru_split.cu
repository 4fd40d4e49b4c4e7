// Where a frame of K1 goes, and what one exchange between the CTAs costs,
// for tools/kernel_ab.py --k1-split.
//
// prego_gru_split: the parent design of K1 (csrc/gru.cu at dc1e0f6: one
// cooperative kernel, CTA j holding 8 hidden units and 24 columns of W_hh,
// h copied from L2 into every CTA each frame, mma.sync, the gate math
// reading xg from global memory, grid.sync), with clock64() stamps around
// its four phases. Each CTA's thread 0 sums, over the frames, the cycles of
// (0) the copy of h into shared memory, (1) the product, (2) the gate math
// and (3) the grid barrier, into stamps[4 * cta + phase].
//
// prego_gru_empty_round: T rounds of an exchange with no work between them,
// over `grid` CTAs of 256 threads, all resident: mode 0 is the cooperative
// grid barrier (grid.sync), mode 1 the split arrive and wait of K1's design
// (thread 0 of each CTA fences and adds one to a counter, then spins with
// relaxed loads until the round's count is complete and fences once; a
// ticket leaves the counter zero), every CTA polling. T x its time is the
// chain floor of a recurrence whose every frame waits on every CTA's
// previous one.
#include <cooperative_groups.h>

#include "../prego_tpu_torch/csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;
constexpr int kCols = 3 * kUnits;
constexpr int kNTiles = kCols / 8;
constexpr int kMaxTile = 64;
constexpr int kPad = 8;

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {
    int ld;
    size_t h, red, state, bytes;
    __host__ __device__ Layout(int H, int B, int tile) {
        ld = H + kPad;
        h = align16(sizeof(__nv_bfloat16) * kCols * ld);
        red = align16(h + sizeof(__nv_bfloat16) * tile * ld);
        state = align16(red + sizeof(float) * kWarps * 16 * kCols);
        bytes = state + sizeof(float) * (B * kUnits + kCols);
    }
};

__device__ __forceinline__ void mma_bf16(float* c, const unsigned int* a, unsigned int b0,
                                         unsigned int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned int ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned int*>(p);
}

__global__ void __launch_bounds__(kThreads) gru_split_kernel(
    const __nv_bfloat16* __restrict__ xg, const float* __restrict__ h0,
    const __nv_bfloat16* __restrict__ w_hh, const float* __restrict__ b_hh,
    __nv_bfloat16* __restrict__ hs, float* __restrict__ hT, __nv_bfloat16* hbuf,
    long long* stamps, int T, int B, int H, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(H, B, tile);
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);
    float* red = reinterpret_cast<float*>(smem + L.red);
    float* state = reinterpret_cast<float*>(smem + L.state);
    float* bias = state + B * kUnits;

    cg::grid_group grid = cg::this_grid();
    const int u0 = blockIdx.x * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    long long spent[4] = {0, 0, 0, 0};

    for (int idx = tid; idx < kCols * H; idx += kThreads) {
        const int k = idx / kCols, c = idx % kCols;
        w_s[c * L.ld + k] =
            w_hh[static_cast<size_t>(k) * 3 * H + (c / kUnits) * H + u0 + c % kUnits];
    }
    for (int c = tid; c < kCols; c += kThreads)
        bias[c] = b_hh[(c / kUnits) * H + u0 + c % kUnits];
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
        const int b = idx / kUnits, u = idx % kUnits;
        const float v = h0[static_cast<size_t>(b) * H + u0 + u];
        state[idx] = v;
        hbuf[static_cast<size_t>(b) * H + u0 + u] = f2bf(v);
    }
    grid.sync();

    const int ksteps = H / 16, per_row = H / 8;
    for (int t = 0; t < T; ++t) {
        const __nv_bfloat16* hcur = hbuf + static_cast<size_t>(t & 1) * B * H;
        unsigned short* hnext =
            reinterpret_cast<unsigned short*>(hbuf + static_cast<size_t>((t + 1) & 1) * B * H);
        for (int r0 = 0; r0 < B; r0 += tile) {
            const int nt = min(tile, B - r0);
            const int mtiles = (nt + 15) / 16;
            const int kparts = kWarps / mtiles;
            const int rows = mtiles * 16;
            __syncthreads();
            long long c0 = clock64();
            for (int i = tid; i < nt * per_row; i += kThreads) {
                const int r = i / per_row, col = i % per_row;
                const uint4 v = __ldcg(
                    reinterpret_cast<const uint4*>(hcur + static_cast<size_t>(r0 + r) * H) + col);
                *reinterpret_cast<uint4*>(h_s + r * L.ld + col * 8) = v;
            }
            __syncthreads();
            long long c1 = clock64();
            spent[0] += c1 - c0;

            if (warp < mtiles * kparts) {
                const int mt = warp / kparts, kp = warp % kparts;
                const int per = (ksteps + kparts - 1) / kparts;
                const int k_end = min(ksteps, (kp + 1) * per);
                float acc[kNTiles][4];
#pragma unroll
                for (int n = 0; n < kNTiles; ++n)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
                const __nv_bfloat16* a_lo = h_s + (mt * 16 + g) * L.ld + 2 * q;
                const __nv_bfloat16* a_hi = a_lo + 8 * L.ld;
                for (int ks = kp * per; ks < k_end; ++ks) {
                    const int k0 = ks * 16;
                    const unsigned int a[4] = {ld32(a_lo + k0), ld32(a_hi + k0),
                                               ld32(a_lo + k0 + 8), ld32(a_hi + k0 + 8)};
#pragma unroll
                    for (int n = 0; n < kNTiles; ++n) {
                        const __nv_bfloat16* bp = w_s + (n * 8 + g) * L.ld + k0 + 2 * q;
                        mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
                    }
                }
                float* out = red + (kp * rows + mt * 16) * kCols;
#pragma unroll
                for (int n = 0; n < kNTiles; ++n) {
                    const int c = n * 8 + 2 * q;
                    out[g * kCols + c] = acc[n][0];
                    out[g * kCols + c + 1] = acc[n][1];
                    out[(g + 8) * kCols + c] = acc[n][2];
                    out[(g + 8) * kCols + c + 1] = acc[n][3];
                }
            }
            __syncthreads();
            long long c2 = clock64();
            spent[1] += c2 - c1;

            for (int idx = tid; idx < nt * kUnits; idx += kThreads) {
                const int r = idx / kUnits, u = idx % kUnits, b = r0 + r;
                float hr = 0.f, hz = 0.f, hn = 0.f;
                for (int kp = 0; kp < kparts; ++kp) {
                    const float* part = red + (kp * rows + r) * kCols;
                    hr += part[u];
                    hz += part[kUnits + u];
                    hn += part[2 * kUnits + u];
                }
                const size_t xo = (static_cast<size_t>(t) * B + b) * 3 * H + u0 + u;
                const float xr = bf2f(xg[xo]), xz = bf2f(xg[xo + H]), xn = bf2f(xg[xo + 2 * H]);
                hr += bias[u];
                hz += bias[kUnits + u];
                hn += bias[2 * kUnits + u];
                const float rg = 1.f / (1.f + expf(-(xr + hr)));
                const float zg = 1.f / (1.f + expf(-(xz + hz)));
                const float ng = tanhf(xn + rg * hn);
                const float hnew = (1.f - zg) * ng + zg * state[b * kUnits + u];
                state[b * kUnits + u] = hnew;
                const __nv_bfloat16 hb = f2bf(hnew);
                hs[(static_cast<size_t>(t) * B + b) * H + u0 + u] = hb;
                __stcg(hnext + static_cast<size_t>(b) * H + u0 + u,
                       *reinterpret_cast<const unsigned short*>(&hb));
            }
            __syncthreads();
            spent[2] += clock64() - c2;
        }
        const long long c3 = clock64();
        grid.sync();
        spent[3] += clock64() - c3;
    }
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
        const int b = idx / kUnits, u = idx % kUnits;
        hT[static_cast<size_t>(b) * H + u0 + u] = state[idx];
    }
    if (tid == 0)
        for (int p = 0; p < 4; ++p) stamps[4 * blockIdx.x + p] = spent[p];
}

__global__ void __launch_bounds__(kThreads) empty_round_kernel(unsigned int* counter, int T,
                                                               int mode) {
    cg::grid_group grid = cg::this_grid();
    const unsigned int n = gridDim.x;
    for (int t = 0; t < T; ++t) {
        if (mode == 0) {
            grid.sync();
            continue;
        }
        __syncthreads();
        if (threadIdx.x == 0) {  // as K1's arrive and wait_arrivals (csrc/gru.cu)
            __threadfence();
            asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
            const unsigned int want = (t + 1) * n;
            unsigned int seen;
            do {
                asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
                             : "=r"(seen)
                             : "l"(counter)
                             : "memory");
            } while (seen < want);
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
        }
        __syncthreads();
    }
    if (mode == 1 && threadIdx.x == 0 && T > 0) {  // the last CTA out leaves both counts zero
        if (atomicAdd(counter + 1, 1u) == n - 1) {
            counter[0] = 0;
            counter[1] = 0;
        }
    }
}

}  // namespace

// The parent's K1 with phase stamps; stamps is (grid, 4) int64.
PREGO_EXPORT int prego_gru_split(const void* xg, const void* h0, const void* w_hh,
                                 const void* b_hh, void* hs, void* hT, void* hbuf, void* stamps,
                                 int T, int B, int H, void* stream) {
    if (T < 0 || B <= 0 || H <= 0 || H % 16 != 0) return PREGO_BAD_ARGUMENT;
    int device = 0, sms = 0, max_smem = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return err;
    if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess)
        return err;
    const int grid = H / kUnits;
    const int per_sm = (grid + sms - 1) / sms;
    const size_t budget = static_cast<size_t>(max_smem) / per_sm - 1024;
    int tile = B < kMaxTile ? (B + 15) / 16 * 16 : kMaxTile;
    while (tile > 16 && Layout(H, B, tile).bytes > budget) tile -= 16;
    const size_t smem = Layout(H, B, tile).bytes;
    if (smem > budget) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&h0), const_cast<void**>(&w_hh),
                    const_cast<void**>(&b_hh), &hs, &hT, &hbuf, &stamps, &T, &B, &H, &tile};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gru_split_kernel), dim3(grid),
                                      dim3(kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? err : cudaGetLastError();
}

// T empty rounds over `grid` CTAs; counter is two zeroed uint32, left zero.
PREGO_EXPORT int prego_gru_empty_round(void* counter, int T, int grid, int mode, void* stream) {
    void* args[] = {&counter, &T, &mode};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(empty_round_kernel), dim3(grid), dim3(kThreads), args, 0,
        static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? err : cudaGetLastError();
}
