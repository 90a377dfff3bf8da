// Squared LB_Keogh of candidates against query envelopes for Hopper
// (sm_90a), full float32: stage 1 of the exact-DTW candidate cascade.
// Replaces the TPU kernel src/repro/kernels/lb_keogh.py::lb_keogh (body
// _kernel: one query envelope against a (block_b, n) candidate tile); the
// one-envelope TPU form is Q = 1 here.
//
// x [m, n] (one candidate block shared by every query, x_qstride = 0) or
// x [Q, m, n] (a candidate set per query, x_qstride = m), U / L [Q, n], all
// f32 row-major, contiguous -> out [Q, m] f32 with
//     out[q, l] = sum_i d^2,  d = max(max(x[l,i] - U[q,i], L[q,i] - x[l,i]), 0)
// which is bitwise the twin's max(max(x - U, 0), max(L - x, 0)) for any U
// and L (L > U included); an infinite envelope edge gives 0, never NaN.
//
// What bounds it: an element costs five instructions (two FADD, two
// FMNMX, one FFMA).  At the search's shape [64, 2048, 256] that is 168 M
// instructions against 2.7 MB of distinct data (~0.8 us at 3.35 TB/s), so
// the shared layout is bound by instruction issue: 128 lanes a clock on
// each SM, ~5 us on 132 SMs at 1.98 GHz.  The per-query layout reads a row
// for every pair and is bound by bytes.  The first kernel read x, U and L
// for every element (three loads for seven operations) and let every block
// read the whole envelope again; load issue alone cost about twice the
// arithmetic.  On an H100 (scripts/probe_lb_keogh.py splits a call) the
// arithmetic now runs at the issue rate, ~6.8 us of an 11.6 us call; the
// copies, which bring 12.6 MB to the SMs for 2.1 MB of distinct data, add
// ~2.3 us, and the launch, barriers and epilogue ~2.5 us.  The design:
//
//   - Shared layout: tiles of 32 queries x 32 candidates, one block of 256
//     threads (8 warps) each: 2 x 64 = 128 blocks at the search's shape.
//     The block's contraction is cut into 4 fixed column classes: column c
//     is in class (c / 4) % 4, and warps 2s and 2s+1 sum class s.  Each of
//     their 64 threads keeps a 4 x 4 register tile: query rows
//     16·w + tq + 4i, candidate rows tx + 8j (w = warp of the pair, lane =
//     8·tq + tx).  A column group costs 12 16-byte shared reads (4 rows
//     each of U, L and x, on distinct banks) for 64 elements.  Where
//     32-query tiles would leave more than half the SMs without a block
//     (the "shared" order's 256-row sub-slab makes 16), the launcher takes
//     tiles of 8 queries x 32 candidates (1 x 4 register tiles) instead:
//     the same sums, four times the blocks.
//   - Per-query layout: nothing is shared across queries, so a tile is one
//     query x 64 of its candidates, one pair a thread: each row is read
//     once, the query's envelope once a block (a broadcast read).
//   - The operands go through shared memory in chunks of 32 columns, a
//     ring of 8 chunks filled by cp.async (the tile's U rows, its L rows,
//     then its candidate rows, row-major with a 4-float pad), seven chunks
//     in flight ahead of the one being summed; one barrier a chunk.  No row
//     is staged whole, so any n runs.
//   - The epilogue adds the 4 classes' partial tiles in class order
//     through shared memory (the ring's space) and stores rows of out
//     32 or 64 consecutive columns at a time.
//
// The sum order: every out[q, l] is a function of x_l, U_q, L_q and n
// alone.  Class s sums d^2 over its columns in increasing order, one FMA a
// column from +0 (zero-filled columns past n add exact zeros), and the
// classes are added as ((S0 + S1) + S2) + S3.  Where a row sits in a tile,
// the tile's size, where a slab starts, Q and m, the layout, the copy
// instance and the call change no bit.  No atomics and no split of the contraction across blocks.
//
// Lengths and alignment: the 16-byte copy instance needs n % 4 == 0 and
// 16-byte-aligned x, U and L; any other call takes the 4-byte copy
// instance (a template parameter), with the same shared layout and the same
// sums.  Rows past Q / m and columns past n are zero-filled by the copies
// and masked at the store; nothing is padded in device memory.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;              // columns a chunk
constexpr int LDK = KC + 4;         // padded row stride of a staged chunk (floats)
constexpr int NS = 8;               // chunks in the ring
constexpr int AHEAD = NS - 1;       // chunks requested ahead of the one summed
constexpr int CLASSES = 4;          // column classes: column c in (c / 4) % 4
constexpr int THREADS = 256;        // two warps a class
static_assert(AHEAD >= 1 && AHEAD < NS, "a slot is refilled once consumed");

// A tile: TQ queries x TX candidates, each thread an RQ x RX register tile
// of its class; a staged chunk holds TQ rows of U, TQ of L, then XROWS
// candidate rows; PLD is the padded row stride of a partial tile.
//
// Shared layout, TQ = 32 (or 8) queries x 32 candidates: thread (w, lane)
// of a class holds query rows (TQ / 2)·w + (lane >> 3) + 4i and candidate
// rows (lane & 7) + 8j.
template <int TQ_> struct SharedTile {
    static constexpr bool PERQ = false;
    static constexpr int TQ = TQ_, TX = 32, XROWS = 32, RQ = TQ_ / 8, RX = 4;
    static constexpr int PLD = TX + 8;
    __device__ static int qrow(int w, int lane, int i) {
        return (TQ / 2) * w + (lane >> 3) + 4 * i;
    }
    __device__ static int xrow(int, int lane, int j) {
        return (lane & 7) + 8 * j;
    }
};
// Per-query layout: one query x 64 of its candidates, one pair a thread.
struct PerQueryTile {
    static constexpr bool PERQ = true;
    static constexpr int TQ = 1, TX = 64, XROWS = 64, RQ = 1, RX = 1;
    static constexpr int PLD = TX;
    __device__ static int qrow(int, int, int) { return 0; }
    __device__ static int xrow(int w, int lane, int) { return 32 * w + lane; }
};

template <class T>
__host__ __device__ constexpr int stage_floats() {
    return (2 * T::TQ + T::XROWS) * LDK;
}
template <class T>
constexpr int smem_bytes() {
    return NS * stage_floats<T>() * (int)sizeof(float);
}
template <class T>
constexpr bool epilogue_fits() {
    return CLASSES * T::TQ * T::PLD <= NS * stage_floats<T>();
}
static_assert(epilogue_fits<SharedTile<32>>() && epilogue_fits<SharedTile<8>>()
              && epilogue_fits<PerQueryTile>(),
              "the epilogue's partial tiles reuse the ring");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage columns k0 .. k0+KC-1 of the tile's rows into a ring slot: 16-byte
// copies (a row's 32 columns by 8 consecutive threads) or 4-byte copies
// (by 32 consecutive threads); out-of-range elements are zero-filled.
template <bool VEC, class T>
__device__ __forceinline__ void load_chunk(
        float* slot, const float* x, const float* U, const float* L, int Q,
        int m, int n, long long xq, int q0, int x0, int k0, int tid) {
    constexpr int PER_ROW = VEC ? KC / 4 : KC;
    constexpr int COPIES = (2 * T::TQ + T::XROWS) * PER_ROW;
#pragma unroll 4
    for (int k = 0; k < (COPIES + THREADS - 1) / THREADS; ++k) {
        const int idx = tid + k * THREADS;
        if (COPIES % THREADS != 0 && idx >= COPIES) break;
        const int r = idx / PER_ROW;
        const int c = (idx % PER_ROW) * (VEC ? 4 : 1);
        const float* row;
        bool in;
        if (r < 2 * T::TQ) {                  // an envelope row
            const int q = q0 + (r < T::TQ ? r : r - T::TQ);
            row = (r < T::TQ ? U : L) + (size_t)q * n;
            in = q < Q;
        } else {                              // a candidate row
            const int l = x0 + r - 2 * T::TQ;
            row = x + ((long long)q0 * xq + l) * n;
            in = l < m;
        }
        in = in && k0 + c < n;
        const float* src = in ? row + k0 + c : x;
        if (VEC) cp_async16(slot + r * LDK + c, src, in);
        else cp_async4(slot + r * LDK + c, src, in);
    }
}

// one element: acc + max(max(v - u, lo - v), 0)^2, rounded once
__device__ __forceinline__ float step(float v, float u, float lo,
                                      float acc) {
    const float d = fmaxf(fmaxf(__fsub_rn(v, u), __fsub_rn(lo, v)), 0.f);
    return fmaf(d, d, acc);
}

template <bool VEC, class T>
__global__ void __launch_bounds__(THREADS, 2)
lb_keogh_kernel(const float* __restrict__ x, const float* __restrict__ U,
                const float* __restrict__ L, float* __restrict__ out, int Q,
                int m, int n, long long xq, int tiles_x) {
    constexpr int STAGE = stage_floats<T>();
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cls = warp >> 1, w = warp & 1;
    const int q0 = (int)(blockIdx.x / tiles_x) * T::TQ;
    const int x0 = (int)(blockIdx.x % tiles_x) * T::TX;
    const int chunks = (n + KC - 1) / KC;

    for (int c = 0; c < AHEAD; ++c) {
        if (c < chunks)
            load_chunk<VEC, T>(smem + c * STAGE, x, U, L, Q, m, n, xq, q0,
                               x0, c * KC, tid);
        cp_async_commit();
    }

    float acc[T::RQ][T::RX];
    int uoff[T::RQ], xoff[T::RX];             // staged row offsets (floats)
#pragma unroll
    for (int i = 0; i < T::RQ; ++i) {
        uoff[i] = T::qrow(w, lane, i) * LDK;  // its L row is TQ rows on
#pragma unroll
        for (int j = 0; j < T::RX; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < T::RX; ++j)
        xoff[j] = (2 * T::TQ + T::xrow(w, lane, j)) * LDK;

    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<AHEAD - 1>();           // this thread's copies of c
        __syncthreads();                      // everyone's; slot c-1 free
        if (c + AHEAD < chunks)
            load_chunk<VEC, T>(smem + ((c + AHEAD) % NS) * STAGE, x, U, L,
                               Q, m, n, xq, q0, x0, (c + AHEAD) * KC, tid);
        cp_async_commit();
        const float* st = smem + (c % NS) * STAGE;
#pragma unroll
        for (int g = 0; g < KC / 4 / CLASSES; ++g) {
            const int col = 4 * (cls + CLASSES * g);
            float4 u[T::RQ], lo[T::RQ], v[T::RX];
#pragma unroll
            for (int i = 0; i < T::RQ; ++i) {
                u[i] = *reinterpret_cast<const float4*>(st + uoff[i] + col);
                lo[i] = *reinterpret_cast<const float4*>(
                    st + uoff[i] + T::TQ * LDK + col);
            }
#pragma unroll
            for (int j = 0; j < T::RX; ++j)
                v[j] = *reinterpret_cast<const float4*>(st + xoff[j] + col);
            // columns col .. col+3 in increasing order for every pair
#pragma unroll
            for (int i = 0; i < T::RQ; ++i)
#pragma unroll
                for (int j = 0; j < T::RX; ++j)
                    acc[i][j] = step(v[j].x, u[i].x, lo[i].x, acc[i][j]);
#pragma unroll
            for (int i = 0; i < T::RQ; ++i)
#pragma unroll
                for (int j = 0; j < T::RX; ++j)
                    acc[i][j] = step(v[j].y, u[i].y, lo[i].y, acc[i][j]);
#pragma unroll
            for (int i = 0; i < T::RQ; ++i)
#pragma unroll
                for (int j = 0; j < T::RX; ++j)
                    acc[i][j] = step(v[j].z, u[i].z, lo[i].z, acc[i][j]);
#pragma unroll
            for (int i = 0; i < T::RQ; ++i)
#pragma unroll
                for (int j = 0; j < T::RX; ++j)
                    acc[i][j] = step(v[j].w, u[i].w, lo[i].w, acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();                          // the ring is free

    float* part = smem;                       // [CLASSES][TQ][PLD]
#pragma unroll
    for (int i = 0; i < T::RQ; ++i)
#pragma unroll
        for (int j = 0; j < T::RX; ++j)
            part[(cls * T::TQ + T::qrow(w, lane, i)) * T::PLD
                 + T::xrow(w, lane, j)] = acc[i][j];
    __syncthreads();

    // output o of the tile: row o / TX, column o % TX (a warp stores 32
    // consecutive columns of one row)
#pragma unroll
    for (int k = 0; k < (T::TQ * T::TX + THREADS - 1) / THREADS; ++k) {
        const int o = tid + k * THREADS;
        if (o >= T::TQ * T::TX) break;
        const int r = o / T::TX, cc = o % T::TX;
        const int gq = q0 + r, gl = x0 + cc;
        if (gq >= Q || gl >= m) continue;
        float s = part[r * T::PLD + cc];
#pragma unroll
        for (int k2 = 1; k2 < CLASSES; ++k2)
            s = __fadd_rn(s, part[(k2 * T::TQ + r) * T::PLD + cc]);
        out[(size_t)gq * m + gl] = s;
    }
}

long long blocks_of(int TQ, int TX, int Q, int m) {
    return (long long)((m + TX - 1) / TX) * ((Q + TQ - 1) / TQ);
}

template <bool VEC, class T>
int launch(const float* x, const float* U, const float* L, float* out,
           int Q, int m, int n, long long xq, int dev, cudaStream_t stream) {
    // the attribute belongs to the current device: raised once per device
    static bool attr_set[64];
    if (!attr_set[dev & 63]) {
        const cudaError_t e = cudaFuncSetAttribute(
            lb_keogh_kernel<VEC, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
        if (e != cudaSuccess) return (int)e;
        attr_set[dev & 63] = true;
    }
    const int tiles_x = (m + T::TX - 1) / T::TX;
    const long long blocks = blocks_of(T::TQ, T::TX, Q, m);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    lb_keogh_kernel<VEC, T><<<(unsigned)blocks, THREADS, smem_bytes<T>(),
                              stream>>>(x, U, L, out, Q, m, n, xq, tiles_x);
    return (int)cudaGetLastError();
}

// the shared layout's tile: 32 queries while that makes at least one block
// for every two SMs, else 8 (the same sums, four times the blocks)
template <bool VEC>
int launch_shared(const float* x, const float* U, const float* L,
                  float* out, int Q, int m, int n, int dev,
                  cudaStream_t stream) {
    static int sm_count[64];
    if (sm_count[dev & 63] == 0) {
        int sms = 0;
        const cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        sm_count[dev & 63] = sms;
    }
    if (2 * blocks_of(32, 32, Q, m) >= sm_count[dev & 63])
        return launch<VEC, SharedTile<32>>(x, U, L, out, Q, m, n, 0, dev,
                                           stream);
    return launch<VEC, SharedTile<8>>(x, U, L, out, Q, m, n, 0, dev, stream);
}

}  // namespace

// dynamic shared memory a block takes (bytes): shared layout (32- and
// 8-query tiles), per-query layout
extern "C" int dumpy_lb_keogh_smem_bytes(int which) {
    return which == 0 ? smem_bytes<SharedTile<32>>()
         : which == 1 ? smem_bytes<SharedTile<8>>()
                      : smem_bytes<PerQueryTile>();
}

extern "C" int dumpy_lb_keogh_f32(const void* x, const void* U, const void* L,
                                  void* out, int Q, int m, int n,
                                  long long x_qstride, void* stream) {
    const auto st = (cudaStream_t)stream;
    if (Q <= 0 || m <= 0) return 0;
    if (n <= 0)                       // empty rows: every bound is 0
        return (int)cudaMemsetAsync(out, 0, (size_t)Q * m * sizeof(float),
                                    st);
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const auto* xf = (const float*)x;
    const auto* uf = (const float*)U;
    const auto* lf = (const float*)L;
    auto* of = (float*)out;
    const bool vec = n % 4 == 0
        && (((uintptr_t)x | (uintptr_t)U | (uintptr_t)L) & 15) == 0;
    if (x_qstride == 0)
        return vec ? launch_shared<true>(xf, uf, lf, of, Q, m, n, dev, st)
                   : launch_shared<false>(xf, uf, lf, of, Q, m, n, dev, st);
    return vec ? launch<true, PerQueryTile>(xf, uf, lf, of, Q, m, n,
                                            x_qstride, dev, st)
               : launch<false, PerQueryTile>(xf, uf, lf, of, Q, m, n,
                                             x_qstride, dev, st);
}
