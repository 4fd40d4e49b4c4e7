// Where a frame of K6 goes, for tools/kernel_ab.py --k6-split.
//
// prego_gru_bwd_split: the design of K6 at 09bfd55 (csrc/gru_bwd.cu there:
// one cooperative kernel, CTA j holding 8 hidden units, W_hh's 24 columns
// and 8 rows in shared memory, h_prev and the whole dHG staged from global
// memory into every CTA each frame, mma.sync, one grid barrier a frame),
// with clock64() stamps around its six phases. Each CTA's thread 0 sums,
// over the frames, the cycles of (0) staging h_prev, (1) the gate product,
// (2) the gate math (xg, dhs and h_prev read from global memory, dxg, r and
// the CTA's dHG columns written), (3) the grid barrier, (4) staging dHG and
// (5) the dh product and its sum, into stamps[6 * cta + phase]. Every phase
// ends in a block barrier, so thread 0's clock spans the block's.
#include <cooperative_groups.h>

#include "../prego_tpu_torch/csrc/common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;
constexpr int kCols = 3 * kUnits;
constexpr int kMaxTile = 64;
constexpr int kPad = 8;
constexpr int kPhases = 6;

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Layout {
    int ld_h, ld_g;
    size_t wt, stage, red, state, bytes;
    __host__ __device__ Layout(int H, int B, int tile_h, int tile_g) {
        ld_h = H + kPad;
        ld_g = 3 * H + kPad;
        wt = align16(sizeof(__nv_bfloat16) * kCols * ld_h);
        stage = align16(wt + sizeof(__nv_bfloat16) * kUnits * ld_g);
        const size_t sh = static_cast<size_t>(tile_h) * ld_h;
        const size_t sg = static_cast<size_t>(tile_g) * ld_g;
        red = align16(stage + sizeof(__nv_bfloat16) * (sh > sg ? sh : sg));
        state = align16(red + sizeof(float) * kWarps * 16 * kCols);
        bytes = state + sizeof(float) * (2 * B * kUnits + kCols);
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

template <bool cg_load>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                           int width, int r0, int nt, int tid) {
    const int per_row = width / 8;
    for (int i = tid; i < nt * per_row; i += kThreads) {
        const int r = i / per_row, col = i % per_row;
        const uint4* p = reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * width) + col;
        *reinterpret_cast<uint4*>(dst + r * ld + col * 8) = cg_load ? __ldcg(p) : __ldg(p);
    }
}

template <int NT>
__device__ __forceinline__ void tile_product(const __nv_bfloat16* a_s, int lda,
                                             const __nv_bfloat16* b_s, int ldb, int ksteps,
                                             int mtiles, float* red, int warp, int lane) {
    const int kparts = kWarps / mtiles;
    if (warp >= mtiles * kparts) return;
    const int g = lane >> 2, q = lane & 3;
    const int mt = warp / kparts, kp = warp % kparts;
    const int per = (ksteps + kparts - 1) / kparts;
    const int k_end = min(ksteps, (kp + 1) * per);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    const __nv_bfloat16* a_lo = a_s + (mt * 16 + g) * lda + 2 * q;
    const __nv_bfloat16* a_hi = a_lo + 8 * lda;
    for (int ks = kp * per; ks < k_end; ++ks) {
        const int k0 = ks * 16;
        const unsigned int a[4] = {ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 8),
                                   ld32(a_hi + k0 + 8)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const __nv_bfloat16* bp = b_s + (n * 8 + g) * ldb + k0 + 2 * q;
            mma_bf16(acc[n], a, ld32(bp), ld32(bp + 8));
        }
    }
    constexpr int NC = NT * 8;
    float* out = red + (kp * mtiles * 16 + mt * 16) * NC;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * q;
        out[g * NC + c] = acc[n][0];
        out[g * NC + c + 1] = acc[n][1];
        out[(g + 8) * NC + c] = acc[n][2];
        out[(g + 8) * NC + c + 1] = acc[n][3];
    }
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads) gru_bwd_split_kernel(
    const __nv_bfloat16* __restrict__ xg, const __nv_bfloat16* __restrict__ hprev,
    const __nv_bfloat16* __restrict__ dhs, const __nv_bfloat16* __restrict__ w_hh,
    const float* __restrict__ b_hh, __nv_bfloat16* __restrict__ dxg,
    __nv_bfloat16* __restrict__ r_out, float* __restrict__ dh0, __nv_bfloat16* gbuf,
    long long* stamps, int T, int B, int H, int tile_h, int tile_g) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(H, B, tile_h, tile_g);
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* wt_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wt);
    __nv_bfloat16* st_s = reinterpret_cast<__nv_bfloat16*>(smem + L.stage);
    float* red = reinterpret_cast<float*>(smem + L.red);
    float* dh = reinterpret_cast<float*>(smem + L.state);
    float* gz = dh + B * kUnits;
    float* bias = gz + B * kUnits;

    cg::grid_group grid = cg::this_grid();
    const int u0 = blockIdx.x * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int H3 = 3 * H;
    long long spent[kPhases] = {0, 0, 0, 0, 0, 0};

    for (int idx = tid; idx < kCols * H; idx += kThreads) {
        const int k = idx / kCols, c = idx % kCols;
        w_s[c * L.ld_h + k] = w_hh[static_cast<size_t>(k) * H3 + (c / kUnits) * H + u0 + c % kUnits];
    }
    for (int idx = tid; idx < kUnits * H3 / 8; idx += kThreads) {
        const int u = idx / (H3 / 8), col = idx % (H3 / 8);
        *reinterpret_cast<uint4*>(wt_s + u * L.ld_g + col * 8) =
            __ldg(reinterpret_cast<const uint4*>(w_hh + static_cast<size_t>(u0 + u) * H3) + col);
    }
    for (int c = tid; c < kCols; c += kThreads) bias[c] = b_hh[(c / kUnits) * H + u0 + c % kUnits];
    for (int idx = tid; idx < B * kUnits; idx += kThreads) dh[idx] = 0.f;
    __syncthreads();

    for (int t = T - 1; t >= 0; --t) {
        unsigned short* gcur =
            reinterpret_cast<unsigned short*>(gbuf + static_cast<size_t>(t & 1) * B * H3);
        const __nv_bfloat16* hp_t = hprev + static_cast<size_t>(t) * B * H;
        for (int r0 = 0; r0 < B; r0 += tile_h) {
            const int nt = min(tile_h, B - r0);
            const int mtiles = (nt + 15) / 16;
            const int kparts = kWarps / mtiles;
            __syncthreads();
            const long long c0 = clock64();
            stage_rows<false>(st_s, L.ld_h, hp_t, H, r0, nt, tid);
            __syncthreads();
            const long long c1 = clock64();
            tile_product<kCols / 8>(st_s, L.ld_h, w_s, L.ld_h, H / 16, mtiles, red, warp, lane);
            __syncthreads();
            const long long c2 = clock64();
            for (int idx = tid; idx < nt * kUnits; idx += kThreads) {
                const int rr = idx / kUnits, u = idx % kUnits, b = r0 + rr;
                float hr = 0.f, hz = 0.f, hn = 0.f;
                for (int kp = 0; kp < kparts; ++kp) {
                    const float* part = red + (kp * mtiles * 16 + rr) * kCols;
                    hr += part[u];
                    hz += part[kUnits + u];
                    hn += part[2 * kUnits + u];
                }
                hr += bias[u];
                hz += bias[kUnits + u];
                hn += bias[2 * kUnits + u];
                const size_t xo = (static_cast<size_t>(t) * B + b) * H3 + u0 + u;
                const size_t ho = (static_cast<size_t>(t) * B + b) * H + u0 + u;
                const float rg = sigmoidf(bf2f(xg[xo]) + hr);
                const float zg = sigmoidf(bf2f(xg[xo + H]) + hz);
                const float ng = tanhf(bf2f(xg[xo + 2 * H]) + rg * hn);
                const float G = bf2f(dhs[ho]) + dh[b * kUnits + u];
                const float dz = G * (bf2f(hprev[ho]) - ng);
                const float db = dz * zg * (1.f - zg);
                const float dn = G * (1.f - zg);
                const float dc = dn * (1.f - ng * ng);
                const float da = dc * hn * rg * (1.f - rg);
                gz[b * kUnits + u] = G * zg;
                dxg[xo] = f2bf(da);
                dxg[xo + H] = f2bf(db);
                dxg[xo + 2 * H] = f2bf(dc);
                r_out[ho] = f2bf(rg);
                const __nv_bfloat16 v[3] = {f2bf(da), f2bf(db), f2bf(dc * rg)};
                unsigned short* row = gcur + static_cast<size_t>(b) * H3 + u0 + u;
#pragma unroll
                for (int gate = 0; gate < 3; ++gate)
                    __stcg(row + gate * H, *reinterpret_cast<const unsigned short*>(&v[gate]));
            }
            __syncthreads();
            const long long c3 = clock64();
            spent[0] += c1 - c0;
            spent[1] += c2 - c1;
            spent[2] += c3 - c2;
        }
        const long long c4 = clock64();
        grid.sync();
        spent[3] += clock64() - c4;

        const __nv_bfloat16* g_t = gbuf + static_cast<size_t>(t & 1) * B * H3;
        for (int r0 = 0; r0 < B; r0 += tile_g) {
            const int nt = min(tile_g, B - r0);
            const int mtiles = (nt + 15) / 16;
            const int kparts = kWarps / mtiles;
            __syncthreads();
            const long long c5 = clock64();
            stage_rows<true>(st_s, L.ld_g, g_t, H3, r0, nt, tid);
            __syncthreads();
            const long long c6 = clock64();
            tile_product<1>(st_s, L.ld_g, wt_s, L.ld_g, H3 / 16, mtiles, red, warp, lane);
            __syncthreads();
            for (int idx = tid; idx < nt * kUnits; idx += kThreads) {
                const int rr = idx / kUnits, u = idx % kUnits, b = r0 + rr;
                float s = 0.f;
                for (int kp = 0; kp < kparts; ++kp) s += red[(kp * mtiles * 16 + rr) * kUnits + u];
                dh[b * kUnits + u] = gz[b * kUnits + u] + s;
            }
            __syncthreads();
            spent[4] += c6 - c5;
            spent[5] += clock64() - c6;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
        const int b = idx / kUnits, u = idx % kUnits;
        dh0[static_cast<size_t>(b) * H + u0 + u] = dh[idx];
    }
    if (tid == 0)
        for (int p = 0; p < kPhases; ++p) stamps[kPhases * blockIdx.x + p] = spent[p];
}

}  // namespace

// K6 of 09bfd55 with phase stamps: its arguments, gbuf (2, B, 3H) bf16
// scratch, and stamps (H / 8, 6) int64.
PREGO_EXPORT int prego_gru_bwd_split(const void* xg, const void* hprev, const void* dhs,
                                     const void* w_hh, const void* b_hh, void* dxg, void* r,
                                     void* dh0, void* gbuf, void* stamps, int T, int B, int H,
                                     void* stream) {
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
    const int cap = B < kMaxTile ? (B + 15) / 16 * 16 : kMaxTile;
    int tile_g = cap;
    while (tile_g > 16 && Layout(H, B, 16, tile_g).bytes > budget) tile_g -= 16;
    int tile_h = cap;
    while (tile_h > 16 && Layout(H, B, tile_h, tile_g).bytes > Layout(H, B, 16, tile_g).bytes)
        tile_h -= 16;
    const size_t smem = Layout(H, B, tile_h, tile_g).bytes;
    if (smem > budget) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_bwd_split_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&hprev), const_cast<void**>(&dhs),
                    const_cast<void**>(&w_hh), const_cast<void**>(&b_hh), &dxg, &r, &dh0, &gbuf,
                    &stamps, &T, &B, &H, &tile_h, &tile_g};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gru_bwd_split_kernel), dim3(grid),
                                      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? err : cudaGetLastError();
}
