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
// needs all of W_hh (H x 3H, 6 MB in bf16 at H = 1024) against a small
// (B, 3H) dHG. One SM cannot hold W_hh, so it is spread over H / 8 CTAs
// that exchange dHG once a frame. At the training shape (T 128, B 16, H
// 1024) the roofline bound is 26 us of tensor-core work; the limit is the
// chain: a frame costs the exchange's latency, the dh product and the few
// operations from G to dHG.
//
// Design: K1's machinery (gru.cu), with everything that does not need dh
// taken off the chain. One persistent kernel for up to kMaxRows batch rows
// (more go in launches of kMaxRows), every CTA resident (a cooperative
// launch), H / 8 CTAs in thread block clusters of C (8 where the card can
// hold the grid so, else 4, 2, 1). CTA j owns 8 hidden units J and keeps
// in registers, for all T frames, its warp's eighth of K of W_hh's 24
// columns of J (the gate product) and of W_hh's 8 rows of J (the dh
// product).
//   Off the chain: r, z and n depend on h_prev and xg only, both inputs, so
//     between its arrival for frame t and its wait, a CTA computes frame
//     t - 1's gates for its units (the product h_prev.W_hh[:, cols(J)] on
//     the tensor cores, h_prev, xg's columns and dhs prefetched with
//     cp.async a frame ahead), writes r, and keeps h_prev - n, z, 1 - n^2,
//     hg_n, r and dhs in shared memory; frame t's dxg is stored after its
//     arrival too.
//   On the chain: dh from the multicast dHG, G = dhs + dh, the five
//     products from G to da, db, dc,
//     dHG[:, cols(J)] = bf16([da, db, dc r]) stored to a (2, rows, 3H)
//     double buffer, and one arrival at the frame counter: a fence, then a
//     relaxed add. No grid barrier.
//   dHG into shared memory: a ninth warp, the producer, joins none of the
//     eight compute warps' barriers. Rank 0's waits for the frame with
//     relaxed loads of the counter until every CTA's arrival is in, then
//     copies each row of dHG with one bulk copy, multicast into all C CTAs'
//     shared memory, completing on each one's mbarrier, while the compute
//     warps do the work off the chain; the other ranks only wait on their
//     barrier. The L2 reads of dHG a frame fall C-fold (12.6 MB to 1.6 MB
//     at B 16, H 1024, C 8).
//     Rows are staged kTile at a time, the tiles of a frame separated by a
//     cluster barrier (a peer must be done with a tile before the next one
//     is multicast over it), and padded by 8 elements so the fragment
//     loads hit 32 distinct banks.
//   Products: mma.sync m16n8k16 (bf16 in, f32 out); each warp takes its
//     eighth of K, and the eight K parts are summed in warp order: no
//     atomics, so two launches on the same inputs give the same bits.
// The counter is left zero by the last CTA to finish, so a call captured in
// a CUDA graph replays.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;          // the compute warps
constexpr int kComputeThreads = 32 * kWarps;
constexpr int kThreads = kComputeThreads + 32;  // and one producer warp
constexpr int kUnits = 8;          // hidden units a CTA
constexpr int kCols = 3 * kUnits;  // W_hh columns a CTA (r, z, n)
constexpr int kNTiles = kCols / 8;
constexpr int kTile = 16;          // rows staged at a time: one m16 tile
constexpr int kMaxRows = 128;      // batch rows a launch
constexpr int kPad = 8;            // bf16 elements of row padding
constexpr int kMaxCluster = 8;
constexpr int kMaxH = 1152;
// k16 steps of H (the gate product) and of 3H (the dh product) a warp holds
constexpr int kMaxGateKSteps = (kMaxH / 16 + kWarps - 1) / kWarps;
constexpr int kMaxDhKSteps = (3 * kMaxH / 16 + kWarps - 1) / kWarps;
constexpr int kCoefs = 6;          // h_prev - n, z, 1 - n^2, hg_n, r, dhs

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory carve-up, computed the same way on the host and the device;
// rows: the batch rows of the launch. At 0 the dHG tile [kTile][ld_g], then
// the offsets of h_prev [2][kTile][ld_h], xg's columns [2][kTile][kCols],
// dhs's [2][kTile][kUnits], the K parts' sums [kWarps][kTile][kCols], the
// coefficients [kCoefs][rows][kUnits], G z [rows][kUnits], the dxg stash
// [rows][kCols] bf16, the bias [kCols] and the mbarrier
struct Layout {
    int ld_h, ld_g;  // padded row lengths of h_prev and dHG, elements
    size_t h, xs, ds, red, coef, state, stash, bias, bar, bytes;
    __host__ __device__ Layout(int H, int rows) {
        ld_h = H + kPad;
        ld_g = 3 * H + kPad;
        h = align16(sizeof(__nv_bfloat16) * kTile * ld_g);
        xs = align16(h + sizeof(__nv_bfloat16) * 2 * kTile * ld_h);
        ds = align16(xs + sizeof(__nv_bfloat16) * 2 * kTile * kCols);
        red = align16(ds + sizeof(__nv_bfloat16) * 2 * kTile * kUnits);
        coef = align16(red + sizeof(float) * kWarps * kTile * kCols);
        state = coef + sizeof(float) * kCoefs * rows * kUnits;
        stash = align16(state + sizeof(float) * rows * kUnits);
        bias = align16(stash + sizeof(__nv_bfloat16) * rows * kCols);
        bar = align16(bias + sizeof(float) * kCols);
        bytes = bar + 8;
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

// two bf16 as one mma operand register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent group of this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one arrival of this CTA at the frame counter: a fence, so that the CTA's
// stores before the barrier that precedes this call reach the whole card
// first, then a relaxed add
__device__ __forceinline__ void arrive(unsigned int* counter) {
    __threadfence();
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
}

// until `count` arrivals are in (relaxed loads, one fence after), then the
// frame's dHG is visible, also to the bulk copies that read it next
__device__ __forceinline__ void wait_arrivals(const unsigned int* counter, unsigned int count) {
    unsigned int seen;
    do {
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < count);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// a barrier of the compute warps, which the producer warp does not join
__device__ __forceinline__ void compute_sync() { hopper::named_bar_sync(1, kComputeThreads); }

__global__ void __launch_bounds__(kThreads, 1) gru_bwd_kernel(
    const __nv_bfloat16* __restrict__ xg,     // (T, B, 3H)
    const __nv_bfloat16* __restrict__ hprev,  // (T, B, H)
    const __nv_bfloat16* __restrict__ dhs,    // (T, B, H)
    const __nv_bfloat16* __restrict__ w_hh,   // (H, 3H)
    const float* __restrict__ b_hh,           // (3H,)
    __nv_bfloat16* __restrict__ dxg,          // (T, B, 3H)
    __nv_bfloat16* __restrict__ r_out,        // (T, B, H)
    float* __restrict__ dh0,                  // (B, H)
    __nv_bfloat16* gbuf,                      // (2, rows, 3H) dHG exchange buffer
    unsigned int* counter,                    // [frame arrivals, CTAs done], zero; left zero
    int T, int B, int H, int b0, int rows) {  // this launch: batch rows [b0, b0 + rows)
    extern __shared__ __align__(16) unsigned char smem[];
    const Layout L(H, rows);
    __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem);            // [kTile][ld_g]
    __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L.h);      // [2][kTile][ld_h]
    __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);    // [2][kTile][kCols]
    __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + L.ds);    // [2][kTile][kUnits]
    float* red = reinterpret_cast<float*>(smem + L.red);  // [K parts (warps)][kTile][kCols]
    float* coef = reinterpret_cast<float*>(smem + L.coef);  // [kCoefs][rows * kUnits]
    float* gz = reinterpret_cast<float*>(smem + L.state);   // [rows][kUnits] G z
    __nv_bfloat16* stash = reinterpret_cast<__nv_bfloat16*>(smem + L.stash);  // dxg [rows][kCols]
    float* bias = reinterpret_cast<float*>(smem + L.bias);  // [kCols]
    const uint32_t bar = hopper::smem_u32(smem + L.bar);

    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks()), rank = cluster.block_rank();
    const int ctas = gridDim.x;
    const int u0 = blockIdx.x * kUnits;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int H3 = 3 * H;
    const int tiles = (rows + kTile - 1) / kTile;
    const int n_rows = rows * kUnits;

    if (tid < kComputeThreads) {
        for (int c = tid; c < kCols; c += kComputeThreads)
            bias[c] = b_hh[(c / kUnits) * H + u0 + c % kUnits];
        for (int e = tid; e < n_rows; e += kComputeThreads) gz[e] = 0.f;
    }
    if (tid == 0) {
        hopper::mbar_init(bar, 1);
        hopper::fence_mbarrier_init();
    }
    cluster.sync();  // every peer's barrier is set before anything is multicast into it

    if (warp == kWarps) {
        // the producer: in exchange e (the dHG of frame T - 1 - e), rank 0's
        // lane 0 waits for the frame's arrivals, then the warp multicasts
        // each tile's rows into the cluster; every rank's producer takes part
        // in the cluster barriers between tiles
        for (int e = 0; e < T; ++e) {
            const __nv_bfloat16* g_t = gbuf + static_cast<size_t>((T - 1 - e) & 1) * rows * H3;
            for (int ti = 0; ti < tiles; ++ti) {
                if (ti > 0) cluster.sync();  // every peer is done with the previous tile's g_s
                if (rank != 0) continue;
                if (lane == 0 && ti == 0) wait_arrivals(counter, (e + 1) * ctas);
                __syncwarp();
                const int r0 = ti * kTile, nt = min(kTile, rows - r0);
                for (int r = lane; r < nt; r += 32) {
                    const uint32_t dst = hopper::smem_u32(g_s + r * L.ld_g);
                    const void* src = g_t + static_cast<size_t>(r0 + r) * H3;
                    if (C > 1)
                        hopper::bulk_load_multicast(dst, src, H3 * 2, bar,
                                                    static_cast<uint16_t>((1u << C) - 1));
                    else
                        hopper::bulk_load(dst, src, H3 * 2, bar);
                }
            }
        }
        cluster.sync();  // no CTA leaves while a peer may still multicast into it
        return;
    }

    // tile n of the gate work (frame T - 1 - n / tiles, rows of tile n %
    // tiles) into buffer n & 1: h_prev's rows, xg's 24 columns and dhs's 8
    // of this CTA; one commit group a tile
    auto prefetch = [&](int n) {
        if (n < T * tiles) {
            const int t = T - 1 - n / tiles, r0 = (n % tiles) * kTile, nt = min(kTile, rows - r0);
            const size_t row0 = static_cast<size_t>(t) * B + b0 + r0;
            const uint32_t hd = hopper::smem_u32(h_s + (n & 1) * kTile * L.ld_h);
            for (int i = tid; i < nt * H / 8; i += kComputeThreads) {
                const int r = i / (H / 8), c = (i % (H / 8)) * 8;
                cp_async_16(hd + (r * L.ld_h + c) * 2, hprev + (row0 + r) * H + c);
            }
            const uint32_t xd = hopper::smem_u32(xs_s + (n & 1) * kTile * kCols);
            const uint32_t dd = hopper::smem_u32(ds_s + (n & 1) * kTile * kUnits);
            for (int i = tid; i < nt * 4; i += kComputeThreads) {
                const int r = i / 4, part = i % 4;  // part < 3: a gate of xg; 3: dhs
                if (part < 3)
                    cp_async_16(xd + (r * kCols + part * kUnits) * 2,
                                xg + (row0 + r) * H3 + part * H + u0);
                else
                    cp_async_16(dd + r * kUnits * 2, dhs + (row0 + r) * H + u0);
            }
        }
        cp_async_commit();
    };

    // This warp's eighth of K of the gate product, and its fragments of
    // W_hh's 24 columns of J there (the col-major B operand; column c =
    // gate * 8 + unit); its eighth of 3H of the dh product, and its
    // fragments of W_hh's 8 rows of J there (B[k][n] = W_hh[u0 + n][k],
    // two consecutive k in one word). Held in registers for all T frames.
    const int g = lane >> 2, q = lane & 3;  // mma fragment: row group, thread in group
    const int ks1 = H / 16, kb1 = warp * ks1 / kWarps, nk1 = (warp + 1) * ks1 / kWarps - kb1;
    const int ks3 = H3 / 16, kb3 = warp * ks3 / kWarps, nk3 = (warp + 1) * ks3 / kWarps - kb3;
    uint32_t wc[kMaxGateKSteps][kNTiles][2];
#pragma unroll
    for (int i = 0; i < kMaxGateKSteps; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
            wc[i][j][0] = wc[i][j][1] = 0;
            if (i < nk1) {
                const int k = (kb1 + i) * 16 + 2 * q, c = j * 8 + g;
                const __nv_bfloat16* w =
                    w_hh + static_cast<size_t>(k) * H3 + (c / kUnits) * H + u0 + c % kUnits;
                const size_t row = static_cast<size_t>(H3);
                wc[i][j][0] = pack_bf16(w[0], w[row]);
                wc[i][j][1] = pack_bf16(w[8 * row], w[9 * row]);
            }
        }
    uint32_t wr[kMaxDhKSteps][2];
#pragma unroll
    for (int i = 0; i < kMaxDhKSteps; ++i) {
        wr[i][0] = wr[i][1] = 0;
        if (i < nk3) {
            const __nv_bfloat16* w = w_hh + static_cast<size_t>(u0 + g) * H3 + (kb3 + i) * 16 + 2 * q;
            wr[i][0] = ld32(w);
            wr[i][1] = ld32(w + 8);
        }
    }
    prefetch(0);

    // the gates of frame t for this CTA's units, tile by tile (n counts the
    // tiles over the frames); r written, the coefficients kept
    auto gate_work = [&](int t, int& n) {
        for (int ti = 0; ti < tiles; ++ti, ++n) {
            const int r0 = ti * kTile, nt = min(kTile, rows - r0);
            prefetch(n + 1);
            cp_async_wait_prior();  // this tile's (the next one's may be in flight)
            compute_sync();
            const __nv_bfloat16* hs = h_s + (n & 1) * kTile * L.ld_h;
            {
                float acc[kNTiles][4];
#pragma unroll
                for (int j = 0; j < kNTiles; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
                for (int i = 0; i < kMaxGateKSteps; ++i) {
                    if (i >= nk1) break;
                    const int k0 = (kb1 + i) * 16 + 2 * q;
                    const __nv_bfloat16* a_lo = hs + g * L.ld_h + k0;
                    const __nv_bfloat16* a_hi = a_lo + 8 * L.ld_h;
                    const unsigned int a[4] = {ld32(a_lo), ld32(a_hi), ld32(a_lo + 8), ld32(a_hi + 8)};
#pragma unroll
                    for (int j = 0; j < kNTiles; ++j) mma_bf16(acc[j], a, wc[i][j][0], wc[i][j][1]);
                }
                // rows at or past nt hold stale values: only their own
                // output rows see them, and those are never read
                float* out = red + warp * kTile * kCols;
#pragma unroll
                for (int j = 0; j < kNTiles; ++j) {
                    const int c = j * 8 + 2 * q;
                    out[g * kCols + c] = acc[j][0];
                    out[g * kCols + c + 1] = acc[j][1];
                    out[(g + 8) * kCols + c] = acc[j][2];
                    out[(g + 8) * kCols + c + 1] = acc[j][3];
                }
            }
            compute_sync();
            const __nv_bfloat16* xs = xs_s + (n & 1) * kTile * kCols;
            const __nv_bfloat16* ds = ds_s + (n & 1) * kTile * kUnits;
            for (int idx = tid; idx < nt * kUnits; idx += kComputeThreads) {
                const int r = idx / kUnits, u = idx % kUnits;
                float hr = 0.f, hz = 0.f, hn = 0.f;
                for (int kp = 0; kp < kWarps; ++kp) {
                    const float* part = red + (kp * kTile + r) * kCols;
                    hr += part[u];
                    hz += part[kUnits + u];
                    hn += part[2 * kUnits + u];
                }
                hr += bias[u];
                hz += bias[kUnits + u];
                hn += bias[2 * kUnits + u];
                const float rg = sigmoidf(bf2f(xs[r * kCols + u]) + hr);
                const float zg = sigmoidf(bf2f(xs[r * kCols + kUnits + u]) + hz);
                const float ng = tanhf(bf2f(xs[r * kCols + 2 * kUnits + u]) + rg * hn);
                const int e = (r0 + r) * kUnits + u;
                coef[0 * n_rows + e] = bf2f(hs[r * L.ld_h + u0 + u]) - ng;
                coef[1 * n_rows + e] = zg;
                coef[2 * n_rows + e] = 1.f - ng * ng;
                coef[3 * n_rows + e] = hn;
                coef[4 * n_rows + e] = rg;
                coef[5 * n_rows + e] = bf2f(ds[r * kUnits + u]);
                r_out[(static_cast<size_t>(t) * B + b0 + r0 + r) * H + u0 + u] = f2bf(rg);
            }
            compute_sync();  // h_s, red and this tile's buffers are free again
        }
    };

    // element e = (row, unit) of frame t's local gradients from G = dhs + dh:
    // G z kept, dxg into the stash and dHG[:, cols(J)] into gcur
    auto grad = [&](int e, float dh, unsigned short* gcur) {
        const int r = e / kUnits, u = e % kUnits;
        const float G = coef[5 * n_rows + e] + dh;
        const float zg = coef[1 * n_rows + e], rg = coef[4 * n_rows + e];
        const float dz = G * coef[0 * n_rows + e];
        const float db = dz * zg * (1.f - zg);
        const float dn = G * (1.f - zg);
        const float dc = dn * coef[2 * n_rows + e];
        const float da = dc * coef[3 * n_rows + e] * rg * (1.f - rg);
        gz[e] = G * zg;
        const __nv_bfloat16 v[3] = {f2bf(da), f2bf(db), f2bf(dc * rg)};
        stash[r * kCols + u] = v[0];
        stash[r * kCols + kUnits + u] = v[1];
        stash[r * kCols + 2 * kUnits + u] = f2bf(dc);
        unsigned short* row = gcur + static_cast<size_t>(r) * H3 + u0 + u;
#pragma unroll
        for (int gate = 0; gate < 3; ++gate)
            __stcg(row + gate * H, *reinterpret_cast<const unsigned short*>(&v[gate]));
    };

    // dh[:, J] = G z + dHG.W_hh[J, :]^T from the multicast dHG, tile by
    // tile, into frame t's local gradients (gcur) or, after frame 0, into dh0
    uint32_t phase = 0;
    auto exchange = [&](unsigned short* gcur) {
        for (int ti = 0; ti < tiles; ++ti) {
            const int r0 = ti * kTile, nt = min(kTile, rows - r0);
            if (ti > 0) cluster.sync();  // every peer is done with the previous tile's g_s
            if (tid == 0) hopper::mbar_arrive_expect_tx(bar, nt * H3 * 2);
            hopper::mbar_wait(bar, phase & 1);
            ++phase;
            {
                // four chains of mma on independent sums, added in order
                float acc[4][4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
                const __nv_bfloat16* a_lo = g_s + g * L.ld_g + kb3 * 16 + 2 * q;
                const __nv_bfloat16* a_hi = a_lo + 8 * L.ld_g;
#pragma unroll
                for (int i = 0; i < kMaxDhKSteps; ++i) {
                    if (i >= nk3) break;
                    const unsigned int a[4] = {ld32(a_lo + 16 * i), ld32(a_hi + 16 * i),
                                               ld32(a_lo + 16 * i + 8), ld32(a_hi + 16 * i + 8)};
                    mma_bf16(acc[i & 3], a, wr[i][0], wr[i][1]);
                }
                float* out = red + warp * kTile * kUnits;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float s = ((acc[0][i] + acc[1][i]) + acc[2][i]) + acc[3][i];
                    out[(g + 8 * (i >> 1)) * kUnits + 2 * q + (i & 1)] = s;
                }
            }
            compute_sync();
            for (int idx = tid; idx < nt * kUnits; idx += kComputeThreads) {
                const int r = idx / kUnits, u = idx % kUnits, e = (r0 + r) * kUnits + u;
                float s = 0.f;
                for (int kp = 0; kp < kWarps; ++kp) s += red[(kp * kTile + r) * kUnits + u];
                if (gcur != nullptr)
                    grad(e, gz[e] + s, gcur);
                else
                    dh0[static_cast<size_t>(b0 + r0 + r) * H + u0 + u] = gz[e] + s;
            }
            compute_sync();  // red is free for the next tile; the tile's stores are in
        }
    };

    int n = 0;
    if (T > 0) gate_work(T - 1, n);
    for (int t = T - 1; t >= 0; --t) {
        unsigned short* gcur =
            reinterpret_cast<unsigned short*>(gbuf + static_cast<size_t>(t & 1) * rows * H3);
        if (t == T - 1) {  // dh is zero
            for (int e = tid; e < n_rows; e += kComputeThreads) grad(e, 0.f, gcur);
            compute_sync();
        } else {
            exchange(gcur);
        }
        if (tid == 0) arrive(counter);  // frame t's dHG: this CTA's columns
        // off the chain: frame t's dxg, then frame t - 1's gates
        for (int i = tid; i < rows * 3; i += kComputeThreads) {
            const int r = i / 3, gate = i % 3;
            *reinterpret_cast<uint4*>(dxg + (static_cast<size_t>(t) * B + b0 + r) * H3 + gate * H + u0) =
                *reinterpret_cast<const uint4*>(stash + r * kCols + gate * kUnits);
        }
        if (t > 0) gate_work(t - 1, n);
    }
    if (T > 0) {
        exchange(nullptr);
    } else {
        for (int e = tid; e < n_rows; e += kComputeThreads)
            dh0[static_cast<size_t>(b0 + e / kUnits) * H + u0 + e % kUnits] = 0.f;
    }
    // the last CTA past its last wait leaves both counts zero
    if (tid == 0 && T > 0 && atomicAdd(counter + 1, 1u) == static_cast<unsigned int>(ctas) - 1) {
        counter[0] = 0;
        counter[1] = 0;
    }
    cluster.sync();  // no CTA leaves while a peer may still multicast into it
}

// The launch: the cluster dimension and the cooperative attribute (every
// CTA resident, or the launch fails); with only_check, the clusters that
// fit on the card at once instead, into *fits
cudaError_t launch(int grid, int cluster, size_t smem, cudaStream_t stream, void** args,
                   bool only_check, int* fits) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute at[2];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    at[1].id = cudaLaunchAttributeCooperative;
    at[1].val.cooperative = 1;
    cfg.attrs = at;
    cfg.numAttrs = only_check ? 1 : 2;
    if (only_check) return cudaOccupancyMaxActiveClusters(fits, gru_bwd_kernel, &cfg);
    return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(gru_bwd_kernel), args);
}

}  // namespace

// dxg (T, B, 3H) bf16, r (T, B, H) bf16 and dh0 (B, H) f32 from xg
// (T, B, 3H) bf16, hprev and dhs (T, B, H) bf16, w_hh (H, 3H) bf16 and
// b_hh (3H,) f32. Workspace: gbuf (2, min(B, 128), 3H) bf16 and counters
// (2,) uint32, zero, left zero. Batches of more than 128 rows run in
// launches of 128. H must be a multiple of 16 of at most 1152, and all H /
// 8 CTAs must fit on the card at once (H <= 1056 on 132 SMs with one CTA
// each).
PREGO_EXPORT int prego_gru_bwd(const void* xg, const void* hprev, const void* dhs,
                               const void* w_hh, const void* b_hh, void* dxg, void* r, void* dh0,
                               void* gbuf, void* counters, int T, int B, int H, void* stream) {
    if (T < 0 || B <= 0 || H <= 0 || H % 16 != 0 || H > kMaxH) return PREGO_BAD_ARGUMENT;
    int device = 0, max_smem = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess)
        return err;
    const int grid = H / kUnits;
    const int most = B < kMaxRows ? B : kMaxRows;
    const size_t smem = Layout(H, most).bytes;
    if (smem > static_cast<size_t>(max_smem)) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // the widest cluster that divides the grid and with which every CTA fits
    int cluster = kMaxCluster;
    for (;; cluster /= 2) {
        if (grid % cluster != 0) continue;
        int fits = 0;
        if ((err = launch(grid, cluster, smem, st, nullptr, true, &fits)) != cudaSuccess) return err;
        if (fits * cluster >= grid) break;
        if (cluster == 1) return cudaErrorCooperativeLaunchTooLarge;
    }
    for (int b0 = 0; b0 < B; b0 += kMaxRows) {
        int rows = B - b0 < kMaxRows ? B - b0 : kMaxRows;
        void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&hprev),
                        const_cast<void**>(&dhs), const_cast<void**>(&w_hh),
                        const_cast<void**>(&b_hh), &dxg, &r, &dh0, &gbuf, &counters,
                        &T, &B, &H, &b0, &rows};
        if ((err = launch(grid, cluster, smem, st, args, false, nullptr)) != cudaSuccess) return err;
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}
