// K6: the reverse-time MiniROAD GRU recurrence (the backward pass) on Hopper.
//
// Replaces prego_tpu/ops/gru_pallas_vjp.py::gru_bwd_pallas (Pallas body
// _gru_bwd_kernel). Per batch row, walking t from T-1 down to 0, with the
// forward's input gates xg_t and previous state h_prev = h_{t-1}:
//   hg = bf16(h_prev).W_hh + b_hh                  (f32 accumulate)
//   r = sigmoid(xg_r + hg_r); z = sigmoid(xg_z + hg_z); n = tanh(xg_n + r hg_n)
//   G = dhs_t + dh
//   dz = G (h_prev - n); db = dz z (1 - z); dn = G (1 - z)
//   dc = dn (1 - n^2);  da = dc hg_n r (1 - r)
//   dh <- G z + bf16([da, db, dc r]).W_hh^T        (f32 accumulate)
// Outputs: dxg_t = [da, db, dc] and r_t in xg's dtype (bf16), and dh0 = dh
// in f32 after frame 0. xg, h_prev, dhs and W_hh arrive bf16, b_hh f32.
//
// What bounds it here: like K1 the chain is sequential in T and every frame
// needs all of W_hh (H x 3H, 6 MB in bf16 at H = 1024), twice: once for the
// gate recompute and once, transposed, for dh. One SM's 227 KB cannot hold
// it, so the weights are spread over many SMs that must meet once a frame.
// At the training shape (T 128, B 16, H 1024) the roofline bound is 26 us
// of tensor-core work; the real limit is the per-frame latency of one grid
// barrier and one exchange of dHG (B x 3H bf16) through L2.
//
// Design: one persistent cooperative kernel, K1's shape. CTA j owns 8 hidden
// units J = [8j, 8j + 8) and keeps in shared memory, for all T frames,
//   * the 24 W_hh columns of its units (the r, z, n columns): the B operand
//     of the gate recompute h_prev.W_hh[:, cols(J)] (48 KB at H = 1024);
//   * the 8 W_hh rows of its units: the B operand of dHG.W_hh[J, :]^T
//     (8 x 3H, 48 KB);
//   * its units' f32 dh chain and G z.
// Per frame a CTA stages h_prev (known up front, no exchange), recomputes
// its units' gates on the tensor cores, forms G, da, db, dc for J, writes
// dxg and r, and writes bf16([da, db, dc r])[:, cols(J)] to a (2, B, 3H) L2
// double buffer with st.global.cg. One grid barrier. Then each CTA stages the
// whole dHG (read with ld.global.cg, so no stale L1 line is used) in row
// tiles and computes dh[:, J] = G z + dHG.W_hh[J, :]^T. The double buffer
// makes one barrier a frame enough: frame t-1 writes the other half while a
// slow CTA still reads frame t's. Products are mma.sync m16n8k16 (bf16 in,
// f32 out), the warps split the rows in 16-row tiles and K in equal parts,
// and the K parts are summed in a fixed order: no atomics, so two launches
// on the same inputs give the same bits. Shared rows are padded by 8
// elements so fragment loads hit 32 distinct banks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;          // hidden units per CTA
constexpr int kCols = 3 * kUnits;  // W_hh columns per CTA (r, z, n)
constexpr int kMaxTile = 64;       // rows staged at a time
constexpr int kPad = 8;            // bf16 elements of row padding

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory carve-up, computed the same way on the host and the device;
// tile_h rows of h_prev (H wide) or tile_g rows of dHG (3H wide) share the
// staging buffer
struct Layout {
    int ld_h, ld_g;  // padded row lengths, elements
    size_t wt, stage, red, state, bytes;
    __host__ __device__ Layout(int H, int B, int tile_h, int tile_g) {
        ld_h = H + kPad;
        ld_g = 3 * H + kPad;
        wt = align16(sizeof(__nv_bfloat16) * kCols * ld_h);
        stage = align16(wt + sizeof(__nv_bfloat16) * kUnits * ld_g);
        const size_t sh = static_cast<size_t>(tile_h) * ld_h;
        const size_t sg = static_cast<size_t>(tile_g) * ld_g;
        const size_t staged = sh > sg ? sh : sg;
        red = align16(stage + sizeof(__nv_bfloat16) * staged);
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

// Copy rows [r0, r0 + nt) of a (rows, width) bf16 matrix into shared rows
// of length ld; width is a multiple of 8 (16-byte loads). ``cg_load`` reads
// around L1, for data other CTAs wrote during this launch.
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

// red[kp][row][c] = sum over this warp's K part of a_s[row, k] * b_s[c, k]
// for NT n8 tiles (c < 8 NT), rows in mtiles 16-row tiles. The caller sums
// the kparts = kWarps / mtiles parts in order. Rows past the staged ones
// hold stale values: only their own output rows see them, never read.
template <int NT>
__device__ __forceinline__ void tile_product(const __nv_bfloat16* a_s, int lda,
                                             const __nv_bfloat16* b_s, int ldb, int ksteps,
                                             int mtiles, float* red, int warp, int lane) {
    const int kparts = kWarps / mtiles;
    if (warp >= mtiles * kparts) return;
    const int g = lane >> 2, q = lane & 3;  // mma fragment: row group, thread in group
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

__global__ void __launch_bounds__(kThreads) gru_bwd_kernel(
    const __nv_bfloat16* __restrict__ xg,     // (T, B, 3H)
    const __nv_bfloat16* __restrict__ hprev,  // (T, B, H)
    const __nv_bfloat16* __restrict__ dhs,    // (T, B, H)
    const __nv_bfloat16* __restrict__ w_hh,   // (H, 3H)
    const float* __restrict__ b_hh,           // (3H,)
    __nv_bfloat16* __restrict__ dxg,          // (T, B, 3H)
    __nv_bfloat16* __restrict__ r_out,        // (T, B, H)
    float* __restrict__ dh0,                  // (B, H)
    __nv_bfloat16* gbuf,                      // (2, B, 3H) dHG exchange buffer
    int T, int B, int H, int tile_h, int tile_g) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(H, B, tile_h, tile_g);
    __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);             // [kCols][ld_h]
    __nv_bfloat16* wt_s = reinterpret_cast<__nv_bfloat16*>(smem + L.wt);     // [kUnits][ld_g]
    __nv_bfloat16* st_s = reinterpret_cast<__nv_bfloat16*>(smem + L.stage);  // staged rows
    float* red = reinterpret_cast<float*>(smem + L.red);      // [K parts][rows][cols]
    float* dh = reinterpret_cast<float*>(smem + L.state);     // [B][kUnits] the chain
    float* gz = dh + B * kUnits;                              // [B][kUnits] G z
    float* bias = gz + B * kUnits;                            // [kCols]

    cg::grid_group grid = cg::this_grid();
    const int u0 = blockIdx.x * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int H3 = 3 * H;

    // W_hh columns of this CTA's units, k contiguous per column (column
    // c = gate * 8 + unit), and W_hh rows of its units, k contiguous per row:
    // both are the col-major B operand of an mma
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

        // 1. gates from h_prev, the local gradients, dxg, r and this CTA's dHG columns
        for (int r0 = 0; r0 < B; r0 += tile_h) {
            const int nt = min(tile_h, B - r0);
            const int mtiles = (nt + 15) / 16;
            const int kparts = kWarps / mtiles;
            __syncthreads();  // the previous tile (or phase) is done with st_s and red
            stage_rows<false>(st_s, L.ld_h, hp_t, H, r0, nt, tid);
            __syncthreads();
            tile_product<kCols / 8>(st_s, L.ld_h, w_s, L.ld_h, H / 16, mtiles, red, warp, lane);
            __syncthreads();
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
        }
        grid.sync();

        // 2. dh[:, J] = G z + dHG . W_hh[J, :]^T over the whole dHG
        const __nv_bfloat16* g_t = gbuf + static_cast<size_t>(t & 1) * B * H3;
        for (int r0 = 0; r0 < B; r0 += tile_g) {
            const int nt = min(tile_g, B - r0);
            const int mtiles = (nt + 15) / 16;
            const int kparts = kWarps / mtiles;
            __syncthreads();
            stage_rows<true>(st_s, L.ld_g, g_t, H3, r0, nt, tid);
            __syncthreads();
            tile_product<1>(st_s, L.ld_g, wt_s, L.ld_g, H3 / 16, mtiles, red, warp, lane);
            __syncthreads();
            for (int idx = tid; idx < nt * kUnits; idx += kThreads) {
                const int rr = idx / kUnits, u = idx % kUnits, b = r0 + rr;
                float s = 0.f;
                for (int kp = 0; kp < kparts; ++kp) s += red[(kp * mtiles * 16 + rr) * kUnits + u];
                dh[b * kUnits + u] = gz[b * kUnits + u] + s;
            }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < B * kUnits; idx += kThreads) {
        const int b = idx / kUnits, u = idx % kUnits;
        dh0[static_cast<size_t>(b) * H + u0 + u] = dh[idx];
    }
}

}  // namespace

// dxg (T, B, 3H) bf16, r (T, B, H) bf16 and dh0 (B, H) f32 from xg
// (T, B, 3H) bf16, hprev and dhs (T, B, H) bf16, w_hh (H, 3H) bf16 and
// b_hh (3H,) f32; gbuf is (2, B, 3H) bf16 scratch. H must be a multiple of
// 16, and all H / 8 CTAs must fit on the card at once (H <= 1024 on 132 SMs
// with one CTA each).
PREGO_EXPORT int prego_gru_bwd(const void* xg, const void* hprev, const void* dhs,
                               const void* w_hh, const void* b_hh, void* dxg, void* r, void* dh0,
                               void* gbuf, int T, int B, int H, void* stream) {
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
    // the CTAs it has to hold, and stage as many rows as then fit
    const int per_sm = (grid + sms - 1) / sms;
    const size_t budget = static_cast<size_t>(max_smem) / per_sm - 1024;
    const int cap = B < kMaxTile ? (B + 15) / 16 * 16 : kMaxTile;
    int tile_g = cap;
    while (tile_g > 16 && Layout(H, B, 16, tile_g).bytes > budget) tile_g -= 16;
    int tile_h = cap;  // h_prev rows are a third as wide: stage more where they fit
    while (tile_h > 16 && Layout(H, B, tile_h, tile_g).bytes > Layout(H, B, 16, tile_g).bytes)
        tile_h -= 16;
    const size_t smem = Layout(H, B, tile_h, tile_g).bytes;
    if (smem > budget) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    int resident = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, gru_bwd_kernel, kThreads,
                                                             smem)) != cudaSuccess)
        return err;
    if (grid > resident * sms) return cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&hprev), const_cast<void**>(&dhs),
                    const_cast<void**>(&w_hh), const_cast<void**>(&b_hh), &dxg, &r, &dh0, &gbuf,
                    &T, &B, &H, &tile_h, &tile_g};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gru_bwd_kernel), dim3(grid),
                                      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
