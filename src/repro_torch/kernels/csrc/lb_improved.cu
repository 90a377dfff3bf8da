// Squared LB_Improved (Lemire 2009; stage 2 of the exact-DTW candidate
// cascade) for Hopper (sm_90a).  Replaces the TPU kernel
// src/repro/kernels/lb_keogh.py::lb_improved (body _improved_kernel), in
// the batched [Q, m] form the search calls.
//
// x [m, n] (shared block, x_qstride = 0) or [Q, m, n] (x_qstride = m),
// qs / U / L [Q, n], band radius r, all f32 row-major -> out [Q, m] f32:
//     d1_i = max(max(x_i - U_i, 0), max(L_i - x_i, 0))         (LB_Keogh)
//     h    = clip(x, L, U)                 (projection onto the envelope)
//     Uh_i = max h[i-r .. i+r],  Lh_i = min h[i-r .. i+r]   (edges clamped)
//     d2_i = max(max(q_i - Uh_i, 0), max(Lh_i - q_i, 0))
//     out  = sum_i d1_i^2 + sum_i d2_i^2
//
// h depends on the query and the candidate, so the sliding max / min runs
// per (query, candidate) pair.  The first design gave each pair a warp and
// took the window by log2(2r+1) doubling passes over a padded row in shared
// memory: ~42 shared-memory accesses and two warp syncs per element, which
// bound it far above its operation count.
//
// This design gives each pair one thread.  A warp holds one query and 32
// candidates (lane = candidate), a block nw warps = nw queries against the
// same 32 candidates.  Each thread streams its row once, head position
// j = 0 .. n-1+r, with van Herk / Gil-Werman blocks of width W = 2r+1:
//   - at j it computes h_j and d1_j, stores h_j in slot j mod W of its
//     buffer and folds it into the running prefix max / min of j's block;
//   - when j ends a block, one backward pass turns the block's h in place
//     into suffix max (and writes suffix min beside it);
//   - output i = j - r takes Uh_i = max(suffix[i-r], prefix[j]): the suffix
//     slot (j+1) mod W of the previous block (of j's own block when j ends
//     it) was consumed one step before the head overwrites it, so one
//     buffer of min(W, n) slots per side is enough.
// That is O(n) per pair and exact (max and min do not round): per element
// 14 f32 instructions (16 operations, an FMA counting two: the clip to h,
// d1 = x - h, the prefix, the backward pass, the window's two ends, the
// clip of q, d2) and 6 buffer accesses.  Every branch depends on j only, so
// a warp never diverges; there is no sync in the inner loop, which runs
// spans of positions with the same edge flags in batches of 8 (then 4, 2,
// 1), every load of a batch issued before its first store.  Buffers are
// [warp][slot][lane] (conflict-free, constant stride).  Chunks of 32
// positions are staged through registers (their global loads in flight
// while the previous chunk computes): the candidates' rows as a transposed
// [pos][cand] tile (shared by the block in the shared layout, per warp
// otherwise) and each warp's U, L and query (shifted by r) interleaved, one
// broadcast 16-byte load a position.
//
// What bounds it: the buffers (2·min(2r+1, n) floats a thread, 408 bytes
// at r=25) cap an SM at 16 resident warps, so the 4096 warps of a
// [64, 2048] slab run in two waves, and in each the four warps a scheduler
// holds share its issue slots (~25 instructions and ~8 shared-memory
// accesses per element and warp, with the backward pass) and the SM's
// shared-memory pipe.  The launcher takes the warps a block that put the
// most warps on an SM, fewer where the grid would leave SMs idle, and fewer
// lanes a warp (down to one) where even one warp of 32 does not fit.
//
// Sums: each thread accumulates 32 squares at a time in f32 (fused
// multiply-add) and those partial sums in f64, then rounds once: within a
// few ulps of the exact sum of the same squares, whatever n.
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;            // head positions per staged chunk
constexpr int TP = C + 1;        // tile row, padded: conflict-free transpose
constexpr int RB = 8;            // positions a run batch loads at once
constexpr int BB = 8;            // slots a backward batch loads at once
constexpr int MAX_NW = 8;
constexpr int PF = 4;            // x elements a thread prefetches a chunk
constexpr int SMEM_MAX = 232448; // an sm_90 block's dynamic shared memory
constexpr long long SM_SMEM = 233472;  // an SM's (1 KB of it per block)
static_assert(C == 32, "a warp stages one chunk position per lane");

// floats of shared memory: the stage of one chunk (each warp's interleaved
// (U, L, q, -) and the candidates' tile or tiles), then the max and min
// buffers, [warp][slot][lane] each
__host__ __device__ inline long long smem_floats(bool shared_x, int nw,
                                                 int lanes, int S) {
    return nw * 4 * C + (shared_x ? 1 : nw) * C * TP + 2LL * nw * S * lanes;
}

// one thread's running state
struct Pair {
    float* bmax;                 // this thread's column of the max buffer
    float* bmin;                 // ... and of the min buffer
    float pmax, pmin;            // prefix max / min of the head's block
    float c1, c2;                // f32 partial sums of this chunk
};

// the chunk's staged inputs as one thread reads them
struct Chunk {
    const float* xt;             // tile + lane: x[j0 + jj] at xt[jj * TP]
    const float4* w;             // w[jj] = (U[j0+jj], L[j0+jj], q[j0+jj-r], -)
};

// NB positions from chunk offset jj of one block, none of them its last
// (slots s .. s+NB-1 < W-1, hoff = s * st): HEAD j < n, OUT j >= r, TAIL
// j >= W (the output's suffix lies in the previous block, slot s + 1).
// Every load of the NB positions (the tail slots s+1 .. s+NB too, which
// the head writes only later) is issued before the first store.  d1 and d2
// are v - clip(v, lo, hi): the square of max(max(v - hi, 0), max(lo - v,
// 0)) bit for bit, as the clip returns hi or lo exactly and v - lo is
// -(lo - v) in IEEE arithmetic.
template <int NB, bool HEAD, bool OUT, bool TAIL>
__device__ __forceinline__ void batch(Pair& p, int jj, int& hoff,
                                      const Chunk& ck, int st) {
    float tmax[NB], tmin[NB], xv[NB];
    float4 w[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        if (TAIL) {
            tmax[k] = p.bmax[hoff + (k + 1) * st];
            tmin[k] = p.bmin[hoff + (k + 1) * st];
        }
        if (HEAD) xv[k] = ck.xt[(jj + k) * TP];
        w[k] = ck.w[jj + k];
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        if (HEAD) {
            const float h = fminf(fmaxf(xv[k], w[k].y), w[k].x);
            const float d1 = __fsub_rn(xv[k], h);
            p.c1 = __fmaf_rn(d1, d1, p.c1);
            p.bmax[hoff + k * st] = h;
            p.pmax = fmaxf(p.pmax, h);
            p.pmin = fminf(p.pmin, h);
        }
        if (OUT) {
            float uh = p.pmax, lh = p.pmin;
            if (TAIL) { uh = fmaxf(uh, tmax[k]); lh = fminf(lh, tmin[k]); }
            const float d2 = __fsub_rn(w[k].z,
                                       fminf(fmaxf(w[k].z, lh), uh));
            p.c2 = __fmaf_rn(d2, d2, p.c2);
        }
    }
    hoff += NB * st;
}

// positions j in [jb, je) with the same flags: batches of RB, then of 4,
// 2 and 1 for the rest
template <bool HEAD, bool OUT, bool TAIL, int ST>
__device__ __forceinline__ void run(Pair& p, int jb, int je, int j0,
                                    int& hoff, const Chunk& ck, int st_rt) {
    const int st = ST ? ST : st_rt;
    int jj = jb - j0;
    const int end = je - j0;
    for (; jj + RB <= end; jj += RB)
        batch<RB, HEAD, OUT, TAIL>(p, jj, hoff, ck, st);
    if (jj + 4 <= end) {
        batch<4, HEAD, OUT, TAIL>(p, jj, hoff, ck, st);
        jj += 4;
    }
    if (jj + 2 <= end) {
        batch<2, HEAD, OUT, TAIL>(p, jj, hoff, ck, st);
        jj += 2;
    }
    if (jj < end) batch<1, HEAD, OUT, TAIL>(p, jj, hoff, ck, st);
}

// the last position j of a block (slot W-1): the head, then the backward
// pass that turns the block's h (slots 0 .. hi) into suffix max / min in
// place, then the output, whose suffix is slot 0 of this block
template <int ST>
__device__ __forceinline__ void block_end(Pair& p, int j, int j0, int n,
                                          int W, const Chunk& ck,
                                          int st_rt) {
    const int st = ST ? ST : st_rt;
    const float INF = __int_as_float(0x7f800000);
    const int jj = j - j0;
    if (j < n) {
        int hoff = (W - 1) * st;
        batch<1, true, false, false>(p, jj, hoff, ck, st);
    }
    int k = min(W - 1, n - 1 - (j - (W - 1)));
    float rmax = -INF, rmin = INF;
    for (; k >= BB - 1; k -= BB) {           // BB loads, then the stores
        float hv[BB];
#pragma unroll
        for (int e = 0; e < BB; ++e) hv[e] = p.bmax[(k - e) * st];
#pragma unroll
        for (int e = 0; e < BB; ++e) {
            rmax = fmaxf(rmax, hv[e]);
            rmin = fminf(rmin, hv[e]);
            p.bmax[(k - e) * st] = rmax;
            p.bmin[(k - e) * st] = rmin;
        }
    }
    for (; k >= 0; --k) {
        const float hv = p.bmax[k * st];
        rmax = fmaxf(rmax, hv);
        rmin = fminf(rmin, hv);
        p.bmax[k * st] = rmax;
        p.bmin[k * st] = rmin;
    }
    // j >= W - 1 >= r: the output always exists
    const float uh = fmaxf(p.pmax, rmax), lh = fminf(p.pmin, rmin);
    const float qv = ck.w[jj].z;
    const float d2 = __fsub_rn(qv, fminf(fmaxf(qv, lh), uh));
    p.c2 = __fmaf_rn(d2, d2, p.c2);
}

// SHARED_X: x is one [m, n] block for every query (x_qstride = 0), staged
// once per block; else each warp stages its query's rows.  FULL: 32 lanes
// a warp, so the buffer stride is the constant 32.
template <bool SHARED_X, bool FULL>
__global__ void __launch_bounds__(MAX_NW * 32, 2)
lb_improved_kernel(const float* __restrict__ x, const float* __restrict__ qs,
                   const float* __restrict__ U, const float* __restrict__ L,
                   float* __restrict__ out, int Q, int m, int n, int r,
                   long long x_qstride, int lanes) {
    extern __shared__ __align__(16) float sm[];
    constexpr int ST = FULL ? 32 : 0;
    const float INF = __int_as_float(0x7f800000);
    const int nw = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int W = 2 * r + 1;
    const int S = min(W, n);
    float4* wst = reinterpret_cast<float4*>(sm);          // [nw][C]
    float* tst = sm + nw * 4 * C;                          // [1 or nw][C][TP]
    float* smax = tst + (SHARED_X ? 1 : nw) * C * TP;      // [nw][S][lanes]
    float* smin = smax + (size_t)nw * S * lanes;
    float* tile = tst + (SHARED_X ? 0 : warp * C * TP);

    const int c0 = blockIdx.x * lanes;
    const int q = blockIdx.y * nw + warp;
    const int qc = min(q, Q - 1);
    const bool active = lane < lanes && c0 + lane < m && q < Q;
    const int rows = min(lanes, m - c0);
    const float* xq = x + (size_t)qc * x_qstride * n;
    const float* uq = U + (size_t)qc * n;
    const float* lq = L + (size_t)qc * n;
    const float* qq = qs + (size_t)qc * n;

    // chunk j0 goes global -> registers (fetch, its loads in flight while
    // the previous chunk computes) -> shared memory (put, between syncs):
    // the candidates' rows as a [pos][cand] tile, position = lane, rows
    // r0 + k * rstep (the block's rows spread over its warps in the shared
    // layout, this warp's own rows otherwise), and this warp's U, L (at j)
    // and q (at j - r), interleaved
    const int r0 = SHARED_X ? warp : 0, rstep = SHARED_X ? nw : 1;
    const int per = rows > r0 ? (rows - r0 + rstep - 1) / rstep : 0;
    const float* xsrc = (SHARED_X ? x : xq) + (size_t)(c0 + r0) * n + lane;
    const size_t kstride = (size_t)rstep * n;
    float* xdst = tile + lane * TP + r0;
    float xr[PF];
    float wu = 0.f, wl = 0.f, wq = 0.f;
    auto fetch = [&](int j0) {
        const bool in = j0 + lane < n && (SHARED_X || q < Q);
#pragma unroll
        for (int k = 0; k < PF; ++k)
            xr[k] = in && k < per ? __ldg(xsrc + k * kstride + j0) : 0.f;
        const int j = j0 + lane, i = j - r;
        wu = j < n ? __ldg(uq + j) : 0.f;
        wl = j < n ? __ldg(lq + j) : 0.f;
        wq = i >= 0 && i < n ? __ldg(qq + i) : 0.f;
    };
    // the first PF rows are prefetched; small blocks (per > PF) load the
    // rest when they put it
    auto put = [&](int j0) {
#pragma unroll
        for (int k = 0; k < PF; ++k)
            if (k < per) xdst[k * rstep] = xr[k];
        const bool in = j0 + lane < n && (SHARED_X || q < Q);
        for (int k = PF; k < per; ++k)
            xdst[k * rstep] = in ? __ldg(xsrc + k * kstride + j0) : 0.f;
        wst[warp * C + lane] = make_float4(wu, wl, wq, 0.f);
    };

    const int st = FULL ? 32 : lanes;
    Pair p{smax + (size_t)warp * S * st + lane,
           smin + (size_t)warp * S * st + lane, -INF, INF, 0.f, 0.f};
    const int jmax = n - 1 + r;               // last head position
    int s = 0, hoff = 0;                      // j mod W, s * st
    double a1 = 0.0, a2 = 0.0;
    fetch(0);
    put(0);
    if (SHARED_X) __syncthreads(); else __syncwarp();
    for (int j0 = 0; j0 <= jmax; j0 += C) {
        const bool next = j0 + C <= jmax;
        if (next) fetch(j0 + C);
        if (active) {
            const Chunk ck{tile + lane, wst + warp * C};
            const int jend = min(j0 + C, jmax + 1);
            int j = j0;
            while (j < jend) {
                if (s == 0) { p.pmax = -INF; p.pmin = INF; }
                if (s == W - 1) {
                    block_end<ST>(p, j, j0, n, W, ck, st);
                    s = 0; hoff = 0; ++j;
                    continue;
                }
                // the longest run with the same HEAD / OUT / TAIL
                int e = min(jend, j + (W - 1 - s));
                if (j < n) e = min(e, n);
                if (j < r) e = min(e, r);
                if (j < W) e = min(e, W);
                if (j < n) {
                    if (j < r)
                        run<true, false, false, ST>(p, j, e, j0, hoff, ck, st);
                    else if (j < W)
                        run<true, true, false, ST>(p, j, e, j0, hoff, ck, st);
                    else
                        run<true, true, true, ST>(p, j, e, j0, hoff, ck, st);
                } else if (j < W) {
                    run<false, true, false, ST>(p, j, e, j0, hoff, ck, st);
                } else {
                    run<false, true, true, ST>(p, j, e, j0, hoff, ck, st);
                }
                s += e - j;
                j = e;
            }
            a1 = __dadd_rn(a1, (double)p.c1);
            a2 = __dadd_rn(a2, (double)p.c2);
            p.c1 = p.c2 = 0.f;
        }
        if (!next) break;
        if (SHARED_X) __syncthreads(); else __syncwarp();
        put(j0 + C);
        if (SHARED_X) __syncthreads(); else __syncwarp();
    }
    if (active)
        out[(size_t)q * m + c0 + lane] = __double2float_rn(__dadd_rn(a1, a2));
}

template <bool SHARED_X, bool FULL>
int launch(const float* x, const float* qs, const float* U, const float* L,
           float* out, int Q, int m, int n, int r, long long x_qstride,
           int nw, int lanes, long long smem, int dev, cudaStream_t stream) {
    // the attribute belongs to the current device: raised once per device
    static bool attr_set[64];
    if (!attr_set[dev & 63]) {
        const cudaError_t e = cudaFuncSetAttribute(
            lb_improved_kernel<SHARED_X, FULL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        attr_set[dev & 63] = true;
    }
    dim3 grid((m + lanes - 1) / lanes, (Q + nw - 1) / nw);
    lb_improved_kernel<SHARED_X, FULL><<<grid, nw * 32, (size_t)smem,
                                         stream>>>(
        x, qs, U, L, out, Q, m, n, r, x_qstride, lanes);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dumpy_lb_improved_f32(const void* x, const void* qs,
                                     const void* U, const void* L, void* out,
                                     int Q, int m, int n, int r,
                                     long long x_qstride, void* stream) {
    const auto st = (cudaStream_t)stream;
    if (n <= 0)                       // empty rows: both sums are 0
        return (int)cudaMemsetAsync(out, 0, (size_t)Q * m * sizeof(float),
                                    st);
    if (r > n - 1) r = n - 1;         // the window already spans the row
    static int sm_count[64];          // per device, read once
    int dev = 0;
    cudaGetDevice(&dev);
    int& sms = sm_count[dev & 63];
    if (sms == 0)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int S = 2 * r + 1 < n ? 2 * r + 1 : n;
    const bool shared_x = x_qstride == 0;
    auto bytes = [&](int nw, int lanes) {
        return 4 * smem_floats(shared_x, nw, lanes, S);
    };
    // the warps a block that put the most warps on an SM (the buffers
    // bound it), then fewer while the grid would hold under two blocks an
    // SM; one warp of fewer lanes where even one warp of 32 does not fit
    auto per_sm = [&](int nw) {
        const long long b = bytes(nw, 32);
        return b > SMEM_MAX ? 0LL : SM_SMEM / (b + 1024) * nw;
    };
    int nw = 1, lanes = 32;
    for (int k = 2; k <= MAX_NW; k <<= 1)
        if (per_sm(k) >= per_sm(nw)) nw = k;
    const long long cand_blocks = (m + 31) / 32;
    while (nw > 1 && cand_blocks * ((Q + nw - 1) / nw) < 2LL * sms)
        nw >>= 1;
    while (lanes > 1 && bytes(nw, lanes) > SMEM_MAX) lanes >>= 1;
    const long long smem = bytes(nw, lanes);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const auto* xf = (const float*)x;
    const auto* qf = (const float*)qs;
    const auto* uf = (const float*)U;
    const auto* lf = (const float*)L;
    auto* of = (float*)out;
    if (shared_x)
        return lanes == 32
            ? launch<true, true>(xf, qf, uf, lf, of, Q, m, n, r, 0, nw, lanes,
                                 smem, dev, st)
            : launch<true, false>(xf, qf, uf, lf, of, Q, m, n, r, 0, nw,
                                  lanes, smem, dev, st);
    return lanes == 32
        ? launch<false, true>(xf, qf, uf, lf, of, Q, m, n, r, x_qstride, nw,
                              lanes, smem, dev, st)
        : launch<false, false>(xf, qf, uf, lf, of, Q, m, n, r, x_qstride,
                               nw, lanes, smem, dev, st);
}
