// K1: the MiniROAD GRU recurrence on Hopper.
//
// Replaces prego_tpu/ops/gru_pallas.py::gru_recurrence_pallas (Pallas body
// _gru_kernel). Per frame t and batch row b, with xg = x.W_ih + b_ih
// precomputed outside (one GEMM):
//   hg = bf16(h).W_hh + b_hh                      (f32 accumulate)
//   r = sigmoid(xg_r + hg_r); z = sigmoid(xg_z + hg_z)
//   n = tanh(xg_n + r * hg_n); h' = (1 - z) n + z h  (f32 state)
// xg arrives bf16 and time-major (T, B, 3H); hs leaves in xg's dtype.
//
// What bounds it here: the recurrence is sequential in T, and each frame
// needs all of W_hh (H x 3H, 6 MB in bf16 at H = 1024) against a small
// (B, H) state, so re-reading W_hh from device memory every frame would
// cost 6 MB x T of traffic for a few hundred MFLOP. The TPU kernel keeps
// W_hh resident in VMEM; one SM's 227 KB of shared memory cannot hold it.
// Per frame the work is then bounded by one grid-wide barrier, the copy
// of h (B x H bf16) into each CTA, and the h.W_hh product.
//
// Design: one persistent cooperative kernel for the whole chunk. CTA j
// owns 8 hidden units [8j, 8j + 8) and keeps the matching 24 columns of
// W_hh (the r, z and n columns of its units) in shared memory for all T
// frames: 24 x 1024 bf16 = 48 KB, over H / 8 = 128 CTAs. Each CTA also
// keeps its units' f32 state in shared memory. Only the bf16 copy of h,
// which every CTA needs whole, goes through global memory (L2): a
// (2, B, H) double buffer, read with ld.global.cg so no stale L1 line is
// used. One grid barrier per frame separates writing frame t's state from
// reading it at frame t+1; the double buffer makes one barrier enough.
// Each frame a CTA copies h into shared memory (up to 64 rows at a time,
// 16-byte loads all in flight) and computes its (rows x 24) slice of
// h.W_hh on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out; the
// warps split the rows in 16-row tiles and K in equal parts, and the K
// parts are summed in a fixed order). Shared rows are padded by 8 elements
// so the fragment loads hit 32 distinct banks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;           // hidden units per CTA
constexpr int kCols = 3 * kUnits;   // W_hh columns per CTA (r, z, n)
constexpr int kNTiles = kCols / 8;  // n8 tiles of the product
constexpr int kMaxTile = 64;        // rows of h staged at a time
constexpr int kPad = 8;             // bf16 elements of row padding

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory carve-up, computed the same way on the host and the device
struct Layout {
    int ld;  // padded row length of w_s and h_s, elements
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

__global__ void __launch_bounds__(kThreads) gru_recurrence_kernel(
    const __nv_bfloat16* __restrict__ xg,    // (T, B, 3H)
    const float* __restrict__ h0,            // (B, H)
    const __nv_bfloat16* __restrict__ w_hh,  // (H, 3H)
    const float* __restrict__ b_hh,          // (3H,)
    __nv_bfloat16* __restrict__ hs,          // (T, B, H)
    float* __restrict__ hT,                  // (B, H)
    __nv_bfloat16* hbuf,                     // (2, B, H) exchange buffer
    int T, int B, int H, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(H, B, tile);
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);        // [kCols][ld]
    __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);  // [tile][ld]
    float* red = reinterpret_cast<float*>(smem + L.red);      // [K parts][rows][kCols]
    float* state = reinterpret_cast<float*>(smem + L.state);  // [B][kUnits]
    float* bias = state + B * kUnits;                         // [kCols]

    cg::grid_group grid = cg::this_grid();
    const int u0 = blockIdx.x * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;  // mma fragment: row group, thread in group

    // W_hh columns of this CTA's units, k contiguous per column: the
    // col-major B operand of the mma. Column c = gate * 8 + unit.
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
            const int kparts = kWarps / mtiles;  // warps sharing one 16-row tile
            const int rows = mtiles * 16;
            __syncthreads();  // the previous tile is done with h_s and red
            for (int i = tid; i < nt * per_row; i += kThreads) {
                const int r = i / per_row, col = i % per_row;
                const uint4 v = __ldcg(
                    reinterpret_cast<const uint4*>(hcur + static_cast<size_t>(r0 + r) * H) + col);
                *reinterpret_cast<uint4*>(h_s + r * L.ld + col * 8) = v;
            }
            __syncthreads();

            if (warp < mtiles * kparts) {
                const int mt = warp / kparts, kp = warp % kparts;
                const int per = (ksteps + kparts - 1) / kparts;
                const int k_end = min(ksteps, (kp + 1) * per);
                float acc[kNTiles][4];
#pragma unroll
                for (int n = 0; n < kNTiles; ++n)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
                // rows at or past nt hold stale values: only their own
                // output rows see them, and those are never read
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

            // gate math, one (row, unit) pair per thread; K parts summed in order
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
        }
        grid.sync();
    }
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
        const int b = idx / kUnits, u = idx % kUnits;
        hT[static_cast<size_t>(b) * H + u0 + u] = state[idx];
    }
}

}  // namespace

// hs (T, B, H) bf16 and hT (B, H) f32 from xg (T, B, 3H) bf16, h0 (B, H)
// f32, w_hh (H, 3H) bf16, b_hh (3H,) f32; hbuf is (2, B, H) bf16 scratch.
// H must be a multiple of 16, and all H / 8 CTAs must fit on the card at
// once (H <= 1024 on 132 SMs with one CTA each).
PREGO_EXPORT int prego_gru_recurrence(const void* xg, const void* h0, const void* w_hh,
                                      const void* b_hh, void* hs, void* hT, void* hbuf, int T,
                                      int B, int H, void* stream) {
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
    // every CTA must be resident at once: share an SM's shared memory among
    // the CTAs it has to hold, and stage as many rows of h as then fit
    const int per_sm = (grid + sms - 1) / sms;
    const size_t budget = static_cast<size_t>(max_smem) / per_sm - 1024;
    int tile = B < kMaxTile ? (B + 15) / 16 * 16 : kMaxTile;
    while (tile > 16 && Layout(H, B, tile).bytes > budget) tile -= 16;
    const size_t smem = Layout(H, B, tile).bytes;
    if (smem > budget) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_recurrence_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    int resident = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, gru_recurrence_kernel,
                                                             kThreads, smem)) != cudaSuccess)
        return err;
    if (grid > resident * sms) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&h0), const_cast<void**>(&w_hh),
                    const_cast<void**>(&b_hh), &hs, &hT, &hbuf, &T, &B, &H, &tile};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gru_recurrence_kernel), dim3(grid),
                                      dim3(kThreads), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
