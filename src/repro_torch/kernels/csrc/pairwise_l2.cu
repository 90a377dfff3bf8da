// Squared-L2 distance matrix for Hopper (sm_90a), full float32.  Replaces
// the TPU kernel src/repro/kernels/pairwise_l2.py::pairwise_l2 (body
// _kernel), the ED candidate slab of the exact search.
//
// q [Q, n], x [X, n] f32 (row-major, contiguous) -> out [Q, X] f32 with
//     out[i, j] = max((|q_i|^2 + |x_j|^2) - 2 q_i.x_j, 0).
//
// What bounds it: at the search's shape [64, 2048, 256] the work is
// 2·Q·X·n = 67 MFLOP of f32 FMA outside the tensor cores (~1 us at
// 67 TFLOP/s) over ~2.6 MB (~0.8 us at 3.35 TB/s), so a call is short and
// its time is latency and how much of the card it fills.  On an H100
// (scripts/probe_pairwise_l2.py splits a call) about 1.6 us of a 5.3 us
// call is launch, barriers and epilogue; the copies take ~2.3 us (the
// tiles bring 8 MB to the SMs: a 32-row query tile is read by 64 blocks,
// a candidate tile by 2, from a slab cold in L2) and the FMAs ~2.2 us at
// about half the f32 issue rate, and the two overlap only in part.
// The design:
//
//   - Tiles of 32 query x 32 candidate rows, one block of 256 threads
//     (8 warps) each: 2 x 64 = 128 blocks at the search's shape, one on
//     each SM it occupies.  The block's contraction is cut into 4 fixed
//     column classes: column c is in class (c / 4) % 4, and warps 2s and
//     2s+1 sum class s.  Each of their 64 threads keeps a 4 x 4 register
//     tile: query rows 16·w + tq + 4i, candidate rows tx + 8j (w = warp
//     of the pair, lane = 8·tq + tx), so a warp's 16-byte shared reads of
//     a column group touch 4 query and 8 candidate rows on distinct banks.
//   - The operands are staged in chunks of 32 columns through a ring of 8
//     chunks in shared memory with cp.async (the tile's 32 query rows,
//     then its 32 candidate rows, row-major with a 4-float pad), seven
//     chunks in flight ahead of the one being summed: at n = 256 all but
//     the last chunk are requested before the first FMA, and the last
//     as soon as the first has landed.  One barrier a chunk.
//   - The row norms are summed from the same staged chunks, spread over
//     all threads: thread l of class s sums row l of the 64 staged rows
//     over the columns of class s, one more 16-byte read and 4 FMAs a
//     column group beside the tile's 8 reads and 64 FMAs.
//   - The epilogue adds the 4 classes' partial tiles and norms in class
//     order through shared memory (the ring's space), and each warp stores
//     32 consecutive columns of a row of out.
//
// Every out[i, j] is a function of q_i and x_j alone: each class sums its
// columns in increasing order with one FMA a column (zero-filled columns
// past n add exact zeros), and the classes and the two norms are added in
// a fixed order.  Where a row sits in a tile, a tile in the grid, or a
// slab in the collection changes nothing, and two calls agree bitwise.
// No atomics and no split of the contraction across blocks.
//
// Lengths and alignment: the 16-byte copy instance needs n % 4 == 0 and
// 16-byte-aligned q and x; any other call takes the 4-byte copy instance
// (a template parameter), with the same shared layout and the same sums,
// so both give the same bits.  Rows past Q / X and columns past n are
// zero-filled by the copies and masked at the store; nothing is padded in
// device memory.  No tensor cores: TF32 keeps ~10 mantissa bits, which
// would move d^2 by ~0.5 at |x|^2 ~ 256 and reorder true neighbours.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;              // query rows of a tile
constexpr int TX = 32;              // candidate rows of a tile
constexpr int ROWS = TQ + TX;       // rows staged a chunk: queries, then candidates
constexpr int KC = 32;              // columns a chunk
constexpr int LDK = KC + 4;         // padded row stride of a staged chunk (floats)
constexpr int NS = 8;               // chunks in the ring
constexpr int CLASSES = 4;          // column classes: column c in (c / 4) % 4
constexpr int THREADS = 256;        // two warps a class
constexpr int PLD = TX + 8;         // padded row stride of a partial tile
constexpr int STAGE = ROWS * LDK;   // floats a ring slot
constexpr int SMEM_BYTES = NS * STAGE * (int)sizeof(float);   // 73 728
static_assert(CLASSES * (TQ * PLD + ROWS) <= NS * STAGE,
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
template <bool VEC>
__device__ __forceinline__ void load_chunk(float* slot, const float* q,
                                           const float* x, int Q, int X,
                                           int n, int q0, int x0, int k0,
                                           int tid) {
    constexpr int PER_ROW = VEC ? KC / 4 : KC;
#pragma unroll
    for (int k = 0; k < ROWS * PER_ROW / THREADS; ++k) {
        const int idx = tid + k * THREADS;
        const int r = idx / PER_ROW;
        const int c = (idx % PER_ROW) * (VEC ? 4 : 1);
        const bool isq = r < TQ;
        const int gr = isq ? q0 + r : x0 + r - TQ;
        const float* base = isq ? q : x;
        const bool in = gr < (isq ? Q : X) && k0 + c < n;
        const float* src = in ? base + (size_t)gr * n + k0 + c : base;
        if (VEC) cp_async16(slot + r * LDK + c, src, in);
        else cp_async4(slot + r * LDK + c, src, in);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int Q, int X, int n) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cls = warp >> 1, w = warp & 1;
    const int tq = lane >> 3, tx = lane & 7;
    const int q0 = blockIdx.y * TQ, x0 = blockIdx.x * TX;
    const int chunks = (n + KC - 1) / KC;

    for (int c = 0; c < NS - 1; ++c) {
        if (c < chunks)
            load_chunk<VEC>(smem + c * STAGE, q, x, Q, X, n, q0, x0, c * KC,
                            tid);
        cp_async_commit();
    }

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float norm = 0.f;
    const int qoff = (16 * w + tq) * LDK;     // query rows 16w + tq + 4i
    const int xoff = (TQ + tx) * LDK;         // candidate rows tx + 8j
    const int noff = (32 * w + lane) * LDK;   // the staged row it norms

    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<NS - 2>();              // this thread's copies of c
        __syncthreads();                      // everyone's; slot c-1 free
        if (c + NS - 1 < chunks)
            load_chunk<VEC>(smem + ((c + NS - 1) % NS) * STAGE, q, x, Q, X,
                            n, q0, x0, (c + NS - 1) * KC, tid);
        cp_async_commit();
        const float* st = smem + (c % NS) * STAGE;
#pragma unroll
        for (int g = 0; g < KC / 4 / CLASSES; ++g) {
            const int col = 4 * (cls + CLASSES * g);
            float4 a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(
                    st + qoff + 4 * i * LDK + col);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                b[j] = *reinterpret_cast<const float4*>(
                    st + xoff + 8 * j * LDK + col);
            const float4 v =
                *reinterpret_cast<const float4*>(st + noff + col);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
                    acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
                    acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
                    acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
                }
            norm = fmaf(v.x, v.x, norm);
            norm = fmaf(v.y, v.y, norm);
            norm = fmaf(v.z, v.z, norm);
            norm = fmaf(v.w, v.w, norm);
        }
    }
    cp_async_wait<0>();
    __syncthreads();                          // the ring is free

    float* part = smem;                       // [CLASSES][TQ][PLD]
    float* norms = smem + CLASSES * TQ * PLD; // [CLASSES][ROWS]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            part[(cls * TQ + 16 * w + tq + 4 * i) * PLD + tx + 8 * j] =
                acc[i][j];
    norms[cls * ROWS + 32 * w + lane] = norm;
    __syncthreads();

    // warp k stores rows k, k+8, k+16, k+24 of the tile, a column a lane
#pragma unroll
    for (int k = 0; k < TQ / 8; ++k) {
        const int r = warp + 8 * k;
        const int gr = q0 + r, gc = x0 + lane;
        if (gr >= Q || gc >= X) continue;
        float dot = part[r * PLD + lane];
        float qn = norms[r], xn = norms[TQ + lane];
#pragma unroll
        for (int s = 1; s < CLASSES; ++s) {
            dot = __fadd_rn(dot, part[(s * TQ + r) * PLD + lane]);
            qn = __fadd_rn(qn, norms[s * ROWS + r]);
            xn = __fadd_rn(xn, norms[s * ROWS + TQ + lane]);
        }
        out[(size_t)gr * X + gc] =
            fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
    }
}

template <bool VEC>
int launch(const float* q, const float* x, float* out, int Q, int X, int n,
           cudaStream_t stream) {
    // the attribute belongs to the current device: raised once per device
    static bool attr_set[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (!attr_set[dev & 63]) {
        const cudaError_t e = cudaFuncSetAttribute(
            pairwise_l2_kernel<VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        attr_set[dev & 63] = true;
    }
    dim3 grid((X + TX - 1) / TX, (Q + TQ - 1) / TQ);
    pairwise_l2_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(
        q, x, out, Q, X, n);
    return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a block of the kernel takes (bytes)
extern "C" int dumpy_pairwise_l2_smem_bytes() { return SMEM_BYTES; }

extern "C" int dumpy_pairwise_l2_f32(const void* q, const void* x, void* out,
                                     int Q, int X, int n, void* stream) {
    const auto st = (cudaStream_t)stream;
    if (Q <= 0 || X <= 0) return 0;
    if (n <= 0)                       // empty rows: every distance is 0
        return (int)cudaMemsetAsync(out, 0, (size_t)Q * X * sizeof(float),
                                    st);
    const auto* qf = (const float*)q;
    const auto* xf = (const float*)x;
    const bool vec = n % 4 == 0
        && (((uintptr_t)q | (uintptr_t)x) & 15) == 0;
    return vec ? launch<true>(qf, xf, (float*)out, Q, X, n, st)
               : launch<false>(qf, xf, (float*)out, Q, X, n, st);
}
