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
// (B, H) state. The TPU kernel keeps W_hh resident in VMEM; one SM's 227 KB
// of shared memory cannot hold it, so W_hh stays spread over H / 8 CTAs
// and every frame ends in one exchange of h between them: a frame costs
// the exchange's latency (its arrivals, the copy of h into every CTA) plus
// the product and the gate math, and T frames are a chain of them.
//
// Design: one persistent kernel for the whole chunk, every CTA resident
// (a cooperative launch), H / 8 CTAs. From kSplitRows rows on, the batch
// is split in two groups of H / 16 CTAs, each with its own half of the rows
// and its own exchange (batch rows are independent sequences): a CTA then
// owns 16 hidden units and half the rows, so it copies half of h a frame
// for the same products. Otherwise one group, 8 units a CTA. A CTA's U
// units' 3U columns of W_hh (r, z and n) stay in registers for all T
// frames, each warp holding one eighth of K, and their f32 state stays in
// shared memory.
//   Exchange: each CTA stores its units' bf16 h into a (2, B, H) double
//     buffer in global memory (the caller's workspace), then, after a fence,
//     adds one to its group's frame counter. No grid barrier: a CTA's
//     stores of hs and its next prefetch run while the others arrive.
//   h into shared memory: the CTAs run in thread block clusters of C (8
//     where the card can hold the grid so, else 4, 2, 1). One thread of the
//     cluster's rank 0 waits for frame t with relaxed loads of the counter
//     until every CTA's arrival is in, then rank 0 copies each row of h with
//     one bulk copy, multicast into all C CTAs' shared memory, completing on
//     each one's mbarrier; the other ranks only wait on their barrier. The
//     L2 reads of h a frame fall C-fold (16.8 MB to 2.1 MB at B 64, H 1024,
//     C 8), and one poller a cluster sees the count. Rows are padded by 8
//     elements so the fragment loads hit 32 distinct banks.
//   xg and hs off the chain: the CTA's 3U columns of the next tile's xg are
//     prefetched into shared memory (cp.async) while the current tile's
//     exchange and product run, and a frame's last rows of hs are stored
//     after its arrival.
//   Product: mma.sync m16n8k16 (bf16 in, f32 out); each warp takes its
//     eighth of K for every 16-row tile of the staged rows, so h_s is read
//     once and W_hh never, and the eight K parts are summed in warp order.
// Batches above 64 rows are staged 64 rows at a time; the tiles of a frame
// are separated by a cluster barrier (a peer must be done with a tile
// before the next one is multicast over it). The counter is left zero by
// the last CTA to finish, so a call captured in a CUDA graph replays.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKSteps = 9;   // k16 steps a warp holds: H <= 16 x 8 warps x 9
constexpr int kPad = 8;         // bf16 elements of row padding
constexpr int kMaxCluster = 8;
constexpr int kSplitRows = 32;  // two groups from here: each has an m16 tile of rows or more

// U hidden units a CTA: its 3U columns of W_hh in n8 tiles, and the rows
// of h staged at a time (the accumulators of those rows' m16 tiles and the
// W_hh fragments share a thread's registers)
template <int U>
struct Units {
    static constexpr int kCols = 3 * U;
    static constexpr int kNTiles = kCols / 8;
    static constexpr int kMaxTile = U == 8 ? 64 : 32;
    static constexpr int kMTiles = kMaxTile / 16;
    static constexpr int kGroups = U / 8;  // CTAs H / 8 in all, H / U a group
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory carve-up, computed the same way on the host and the device;
// rows: the most rows a group has
template <int U>
struct Layout {
    int ld;  // padded row length of h_s, elements
    size_t red, xg, bar, state, bytes;
    __host__ __device__ Layout(int H, int rows, int tile) {
        constexpr int kCols = Units<U>::kCols;
        ld = H + kPad;
        red = align16(sizeof(__nv_bfloat16) * tile * ld);
        xg = align16(red + sizeof(float) * kWarps * tile * kCols);
        bar = align16(xg + sizeof(__nv_bfloat16) * 2 * tile * kCols);
        state = bar + 16;
        bytes = state + sizeof(float) * (rows * U + kCols);
    }
};

// the rows [r0, r1) of group g of G
__host__ __device__ __forceinline__ void group_rows(int g, int G, int B, int& r0, int& r1) {
    r0 = g * B / G;
    r1 = (g + 1) * B / G;
}

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
// frame's h is visible, also to the bulk copies that read it next
__device__ __forceinline__ void wait_arrivals(const unsigned int* counter, unsigned int count) {
    unsigned int seen;
    do {
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < count);
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <int U>
__global__ void __launch_bounds__(kThreads) gru_recurrence_kernel(
    const __nv_bfloat16* __restrict__ xg,    // (T, B, 3H)
    const float* __restrict__ h0,            // (B, H)
    const __nv_bfloat16* __restrict__ w_hh,  // (H, 3H)
    const float* __restrict__ b_hh,          // (3H,)
    __nv_bfloat16* __restrict__ hs,          // (T, B, H)
    float* __restrict__ hT,                  // (B, H)
    __nv_bfloat16* hbuf,                     // (2, B, H) exchange buffer
    unsigned int* counters,  // a group's [frame arrivals, CTAs done], zero; left zero
    int T, int B, int H, int tile) {
    using Un = Units<U>;
    constexpr int kCols = Un::kCols, kNTiles = Un::kNTiles, kMTiles = Un::kMTiles;
    constexpr int G = Un::kGroups;
    extern __shared__ __align__(16) unsigned char smem[];
    const int ctas = H / U;  // a group's
    const int group = blockIdx.x / ctas;
    int gr0, gr1;
    group_rows(group, G, B, gr0, gr1);
    const int rows = gr1 - gr0;  // this group's batch rows
    int most0, most1;
    group_rows(G - 1, G, B, most0, most1);
    const Layout<U> L(H, most1 - most0, tile);  // the last group has the most rows
    __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [tile][ld]
    float* red = reinterpret_cast<float*>(smem + L.red);      // [K parts (warps)][tile][kCols]
    __nv_bfloat16* xg_s = reinterpret_cast<__nv_bfloat16*>(smem + L.xg);  // [2][tile][kCols]
    float* state = reinterpret_cast<float*>(smem + L.state);  // [rows][U]
    float* bias = state + rows * U;                           // [kCols]
    const uint32_t bar = hopper::smem_u32(smem + L.bar);
    unsigned int* counter = counters + 2 * group;

    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.num_blocks()), rank = cluster.block_rank();
    const int u0 = (blockIdx.x % ctas) * U;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;  // mma fragment: row group, thread in group
    const int tiles = (rows + tile - 1) / tile;

    // xg's 3U columns of this CTA for tile n (frame n / tiles) into buffer
    // n & 1: 16 bytes a (row, gate, 8 units); one commit group a tile
    auto prefetch_xg = [&](int n) {
        if (n < T * tiles) {
            const int t = n / tiles, r0 = (n % tiles) * tile, nt = min(tile, rows - r0);
            const uint32_t dst = hopper::smem_u32(xg_s + (n & 1) * tile * kCols);
            for (int i = tid; i < nt * kCols / 8; i += kThreads) {
                const int r = i / (kCols / 8), c = (i % (kCols / 8)) * 8;  // c = gate U + unit
                cp_async_16(dst + (r * kCols + c) * 2,
                            xg + (static_cast<size_t>(t) * B + gr0 + r0 + r) * 3 * H +
                                (c / U) * H + u0 + c % U);
            }
        }
        cp_async_commit();
    };

    // This warp's eighth of K, and its fragments of W_hh's 3U columns there
    // (the col-major B operand of the mma; column c = gate * U + unit), held
    // in registers for all T frames
    const int ksteps = H / 16;
    const int kbeg = warp * ksteps / kWarps, nks = (warp + 1) * ksteps / kWarps - kbeg;
    uint32_t wf[kMaxKSteps][kNTiles][2];
#pragma unroll
    for (int i = 0; i < kMaxKSteps; ++i)
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
            wf[i][j][0] = wf[i][j][1] = 0;
            if (i < nks) {
                const int k = (kbeg + i) * 16 + 2 * q, c = j * 8 + g;
                const __nv_bfloat16* w =
                    w_hh + static_cast<size_t>(k) * 3 * H + (c / U) * H + u0 + c % U;
                const size_t row = static_cast<size_t>(3) * H;
                wf[i][j][0] = pack_bf16(w[0], w[row]);
                wf[i][j][1] = pack_bf16(w[8 * row], w[9 * row]);
            }
        }
    for (int c = tid; c < kCols; c += kThreads) bias[c] = b_hh[(c / U) * H + u0 + c % U];
    for (int idx = tid; idx < rows * U; idx += kThreads) {
        const int b = gr0 + idx / U, u = idx % U;
        const float v = h0[static_cast<size_t>(b) * H + u0 + u];
        state[idx] = v;
        hbuf[static_cast<size_t>(b) * H + u0 + u] = f2bf(v);
    }
    if (tid == 0) {
        hopper::mbar_init(bar, 1);
        hopper::fence_mbarrier_init();
    }
    prefetch_xg(0);
    __syncthreads();
    if (tid == 0 && T > 0) arrive(counter);  // h0 is frame 0's h
    cluster.sync();  // every peer's barrier is set before anything is multicast into it

    for (int t = 0; t < T; ++t) {
        const __nv_bfloat16* hcur = hbuf + static_cast<size_t>(t & 1) * B * H;
        unsigned short* hnext =
            reinterpret_cast<unsigned short*>(hbuf + static_cast<size_t>((t + 1) & 1) * B * H);
        for (int ti = 0; ti < tiles; ++ti) {
            const int n = t * tiles + ti, r0 = ti * tile;
            const int nt = min(tile, rows - r0);
            const int mtiles = (nt + 15) / 16;
            prefetch_xg(n + 1);
            if (ti > 0) cluster.sync();  // every peer is done with the previous tile's h_s
            // rank 0 of the cluster waits for the frame and copies every row
            // of the tile into all the cluster's CTAs; the others only wait
            // for the bytes to land
            if (warp == 0) {
                if (lane == 0) {
                    if (rank == 0 && ti == 0) wait_arrivals(counter, (t + 1) * ctas);
                    hopper::mbar_arrive_expect_tx(bar, nt * H * 2);
                }
                __syncwarp();
                if (rank == 0)
                    for (int r = lane; r < nt; r += 32) {
                        const uint32_t dst = hopper::smem_u32(h_s + r * L.ld);
                        const void* src = hcur + static_cast<size_t>(gr0 + r0 + r) * H;
                        if (C > 1)
                            hopper::bulk_load_multicast(dst, src, H * 2, bar,
                                                        static_cast<uint16_t>((1u << C) - 1));
                        else
                            hopper::bulk_load(dst, src, H * 2, bar);
                    }
            }
            hopper::mbar_wait(bar, n & 1);

            // this warp's eighth of K for every m16 tile of the rows; its
            // sums to red[warp] (rows at or past nt hold stale values: only
            // their own output rows see them, and those are never read)
            {
                float acc[kMTiles][kNTiles][4];
#pragma unroll
                for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
                    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
                        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;
#pragma unroll
                for (int i = 0; i < kMaxKSteps; ++i) {
                    if (i >= nks) break;
                    const int k0 = (kbeg + i) * 16 + 2 * q;
#pragma unroll
                    for (int mt = 0; mt < kMTiles; ++mt) {
                        if (mt >= mtiles) break;
                        const __nv_bfloat16* a_lo = h_s + (mt * 16 + g) * L.ld + k0;
                        const __nv_bfloat16* a_hi = a_lo + 8 * L.ld;
                        const unsigned int a[4] = {ld32(a_lo), ld32(a_hi), ld32(a_lo + 8),
                                                   ld32(a_hi + 8)};
#pragma unroll
                        for (int j = 0; j < kNTiles; ++j)
                            mma_bf16(acc[mt][j], a, wf[i][j][0], wf[i][j][1]);
                    }
                }
                float* out = red + warp * tile * kCols;
#pragma unroll
                for (int mt = 0; mt < kMTiles; ++mt) {
                    if (mt >= mtiles) break;
#pragma unroll
                    for (int j = 0; j < kNTiles; ++j) {
                        const int c = j * 8 + 2 * q, r = mt * 16 + g;
                        out[r * kCols + c] = acc[mt][j][0];
                        out[r * kCols + c + 1] = acc[mt][j][1];
                        out[(r + 8) * kCols + c] = acc[mt][j][2];
                        out[(r + 8) * kCols + c + 1] = acc[mt][j][3];
                    }
                }
            }
            cp_async_wait_prior();  // this tile's xg (the next tile's may be in flight)
            __syncthreads();

            // gate math, one (row, unit) pair per thread; K parts summed in order
            const __nv_bfloat16* xs = xg_s + (n & 1) * tile * kCols;
            for (int idx = tid; idx < nt * U; idx += kThreads) {
                const int r = idx / U, u = idx % U, b = gr0 + r0 + r;
                float hr = 0.f, hz = 0.f, hn = 0.f;
                for (int kp = 0; kp < kWarps; ++kp) {
                    const float* part = red + (kp * tile + r) * kCols;
                    hr += part[u];
                    hz += part[U + u];
                    hn += part[2 * U + u];
                }
                const float xr = bf2f(xs[r * kCols + u]), xz = bf2f(xs[r * kCols + U + u]),
                            xn = bf2f(xs[r * kCols + 2 * U + u]);
                hr += bias[u];
                hz += bias[U + u];
                hn += bias[2 * U + u];
                const float rg = 1.f / (1.f + expf(-(xr + hr)));
                const float zg = 1.f / (1.f + expf(-(xz + hz)));
                const float ng = tanhf(xn + rg * hn);
                float* st = state + (r0 + r) * U + u;
                const float hnew = (1.f - zg) * ng + zg * *st;
                *st = hnew;
                const __nv_bfloat16 hb = f2bf(hnew);
                __stcg(hnext + static_cast<size_t>(b) * H + u0 + u,
                       *reinterpret_cast<const unsigned short*>(&hb));
                if (ti + 1 < tiles) hs[(static_cast<size_t>(t) * B + b) * H + u0 + u] = hb;
            }
            __syncthreads();  // h_s, red and this xg buffer are free again
        }
        if (tid == 0 && t + 1 < T) arrive(counter);  // frame t + 1's h: this CTA's units
        // the frame's last tile of hs, off the chain: after the arrival
        const int r0 = (tiles - 1) * tile;
        for (int idx = tid; idx < (rows - r0) * U; idx += kThreads) {
            const int r = r0 + idx / U, u = idx % U;
            hs[(static_cast<size_t>(t) * B + gr0 + r) * H + u0 + u] = f2bf(state[r * U + u]);
        }
    }
    for (int idx = tid; idx < rows * U; idx += kThreads) {
        const int r = idx / U, u = idx % U;
        hT[static_cast<size_t>(gr0 + r) * H + u0 + u] = state[idx];
    }
    // the group's last CTA past its last wait leaves both counts zero
    if (tid == 0 && T > 0 && atomicAdd(counter + 1, 1u) == static_cast<unsigned int>(ctas) - 1) {
        counter[0] = 0;
        counter[1] = 0;
    }
    cluster.sync();  // no CTA leaves while a peer may still multicast into it
}

// The launch: the cluster dimension and the cooperative attribute (every
// CTA resident, or the launch fails); with only_check, the clusters that
// fit on the card at once instead, into *fits
template <int U>
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
    if (only_check)
        return cudaOccupancyMaxActiveClusters(fits, gru_recurrence_kernel<U>, &cfg);
    return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(gru_recurrence_kernel<U>),
                               args);
}

template <int U>
int run(const void* xg, const void* h0, const void* w_hh, const void* b_hh, void* hs, void* hT,
        void* hbuf, void* counters, int T, int B, int H, cudaStream_t stream) {
    using Un = Units<U>;
    int device = 0, sms = 0, max_smem = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return err;
    if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess)
        return err;
    const int grid = H / 8, ctas = H / U;  // in all, and a group's
    int r0, r1;
    group_rows(Un::kGroups - 1, Un::kGroups, B, r0, r1);
    const int rows = r1 - r0;  // the most a group has
    // every CTA must be resident at once: share an SM's shared memory among
    // the CTAs it has to hold, and stage as many rows of h as then fit
    const int per_sm = (grid + sms - 1) / sms;
    const size_t budget = static_cast<size_t>(max_smem) / per_sm - 1024;
    int tile = rows < Un::kMaxTile ? (rows + 15) / 16 * 16 : Un::kMaxTile;
    while (tile > 16 && Layout<U>(H, rows, tile).bytes > budget) tile -= 16;
    const size_t smem = Layout<U>(H, rows, tile).bytes;
    if (smem > budget) return PREGO_BAD_ARGUMENT;
    if ((err = cudaFuncSetAttribute(gru_recurrence_kernel<U>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem))) != cudaSuccess)
        return err;
    // the widest cluster that divides a group and with which every CTA fits
    int cluster = kMaxCluster;
    for (;; cluster /= 2) {
        if (ctas % cluster != 0) continue;
        int fits = 0;
        if ((err = launch<U>(grid, cluster, smem, stream, nullptr, true, &fits)) != cudaSuccess)
            return err;
        if (fits * cluster >= grid) break;
        if (cluster == 1) return cudaErrorCooperativeLaunchTooLarge;
    }
    void* args[] = {const_cast<void**>(&xg), const_cast<void**>(&h0), const_cast<void**>(&w_hh),
                    const_cast<void**>(&b_hh), &hs, &hT, &hbuf, &counters, &T, &B, &H, &tile};
    err = launch<U>(grid, cluster, smem, stream, args, false, nullptr);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// hs (T, B, H) bf16 and hT (B, H) f32 from xg (T, B, 3H) bf16, h0 (B, H)
// f32, w_hh (H, 3H) bf16, b_hh (3H,) f32. Workspace: hbuf (2, B, H) bf16 and
// counters (4,) uint32, zero, left zero. H must be a multiple of 16 of at
// most 1152, and all H / 8 CTAs must fit on the card at once (H <= 1056 on
// 132 SMs with one CTA each).
PREGO_EXPORT int prego_gru_recurrence(const void* xg, const void* h0, const void* w_hh,
                                      const void* b_hh, void* hs, void* hT, void* hbuf,
                                      void* counters, int T, int B, int H, void* stream) {
    if (T < 0 || B <= 0 || H <= 0 || H % 16 != 0 || H / 16 > kWarps * kMaxKSteps)
        return PREGO_BAD_ARGUMENT;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (B >= kSplitRows) return run<16>(xg, h0, w_hh, b_hh, hs, hT, hbuf, counters, T, B, H, st);
    return run<8>(xg, h0, w_hh, b_hh, hs, hT, hbuf, counters, T, B, H, st);
}
