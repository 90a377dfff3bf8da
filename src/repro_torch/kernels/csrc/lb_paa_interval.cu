// Squared interval MINDIST (the exact-search pruning scan) for Hopper
// (sm_90a).  Replaces the TPU kernel src/repro/kernels/lb_isax.py::
// lb_paa_interval (body _kernel; lb_isax is its degenerate ED case).
//
// seg_lo / seg_hi [Q, w] query intervals, lo / hi [L, w] region bounds, all
// f32 row-major, contiguous -> out [Q, L] f32 with
//     out[q, l] = scale * sum_j max(lo[l,j] - seg_hi[q,j], seg_lo[q,j] - hi[l,j], 0)^2
// scale = n / w, summed over j in order from +0: acc = fl(acc + fl(d*d)),
// then fl(scale * acc).  That is bitwise an in-order loop of separate
// subtractions, maxima, products and sums (no FMA), at any tile position,
// copy width or launch shape.  Leaves bounded by +inf (the pad leaf of
// every shard) give +inf: max(+inf - qhi, qlo - +inf, 0) = +inf, never NaN.
//
// What bounds it: an element is six instructions (two FADD, two FMNMX,
// FMUL, FADD; the product is rounded before the add, so no FFMA), four of
// them on the float32 pipe.  At the search's shape [64, 757, 16] the work
// is 0.78 M elements, far below one launch; at a 100 M-series collection's
// table, [256, 18 925, 16], it is 77.5 M elements and 19.4 MB of bounds.
// On an H100 (scripts/probe_lb_paa_interval.py) the arithmetic binds
// there: ~0.7 instructions a clock on each scheduler, any one instruction
// fewer an element saves 9-12%, twice the warps nothing, and the stores
// add ~1 us.  Six instructions is the floor for these bits.  The design:
//
//   - One thread holds one leaf's lo / hi rows in registers (16-byte loads
//     where w % 4 == 0 and the tables are 16-byte aligned, all issued
//     before the first is used), for the widths the index uses (w = 8, 16:
//     compile-time, fully unrolled).  Two leaves a thread took 103
//     registers and ran 7% slower at the large shape.
//   - A block stages the intervals of its queries in shared memory,
//     interleaved (lo, hi), and every lane reads them as one broadcast
//     16-byte load a query and two columns.
//   - A thread sums QI = 4 queries at once (4 independent chains), then
//     stores 4 bounds; a warp's store is 32 consecutive leaves of a query.
//   - The launcher sizes the grid to the card: 64 threads (64 leaves) a
//     block and as many queries a block (4 to 64) as keep 8 blocks an SM,
//     down to 32 threads where fewer blocks than SMs would run: [64, 757]
//     makes 192 blocks, [256, 18 925] 1184.
//   - Any other w takes the generic instance: 4 queries a block, the
//     columns streamed in chunks of 16 through shared memory and
//     registers, zero-filled past w (an exact +0 added), the sums kept in
//     registers across chunks.  No width is refused.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int R = 1;      // leaves a thread
constexpr int QI = 4;     // queries a thread sums at once
constexpr int JC = 16;    // columns a chunk of the generic instance
constexpr int QPB_MAX = 64;

// one element: fl(acc + fl(d*d)), d = max(lo - qh, ql - hi, 0).  Taking
// the maximum of the two gaps first and of 0 last gives the bits of the
// twin's max(max(lo - qh, 0), max(ql - hi, 0)) for every input: fmaxf
// drops a NaN operand, and the sign of a zero d is squared away.
__device__ __forceinline__ float step(float acc, float lo, float hi,
                                      float ql, float qh) {
    const float d = fmaxf(fmaxf(__fsub_rn(lo, qh), __fsub_rn(ql, hi)), 0.f);
    return __fadd_rn(acc, __fmul_rn(d, d));
}

// QI queries x R leaves over W columns (W even): q holds each query's
// (lo, hi) pairs, stride W pairs a query; columns in increasing order
template <int W>
__device__ __forceinline__ void group(const float2* __restrict__ q,
                                      const float (&lo)[R][W],
                                      const float (&hi)[R][W],
                                      float (&acc)[QI][R]) {
#pragma unroll
    for (int j = 0; j < W; j += 2) {
#pragma unroll
        for (int i = 0; i < QI; ++i) {
            // (lo_j, hi_j, lo_j+1, hi_j+1): one broadcast 16-byte load
            const float4 v = *reinterpret_cast<const float4*>(q + i * W + j);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                acc[i][r] = step(acc[i][r], lo[r][j], hi[r][j], v.x, v.y);
                acc[i][r] = step(acc[i][r], lo[r][j + 1], hi[r][j + 1],
                                 v.z, v.w);
            }
        }
    }
}

__device__ __forceinline__ void store(float* __restrict__ out,
                                      const float (&acc)[QI][R], int Q,
                                      int L, int q0, int l0, int T,
                                      float scale) {
#pragma unroll
    for (int i = 0; i < QI; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int l = l0 + r * T;
            if (q0 + i < Q && l < L)
                out[(size_t)(q0 + i) * L + l] = __fmul_rn(scale, acc[i][r]);
        }
    }
}

// w = W: the leaves' rows in registers for the whole block, its qpb
// queries (a multiple of QI) staged once, walked QI at a time
template <int W>
__global__ void __launch_bounds__(64, 8)
lb_paa_interval_kernel(const float* __restrict__ seg_lo,
                       const float* __restrict__ seg_hi,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       float* __restrict__ out, int Q, int L, float scale,
                       int qpb, int tiles_l, bool vec) {
    extern __shared__ __align__(16) float2 qs[];          // [qpb][W]
    const int T = blockDim.x, tid = threadIdx.x;
    const int l0 = (int)(blockIdx.x % tiles_l) * (R * T) + tid;
    const int q0 = (int)(blockIdx.x / tiles_l) * qpb;

    float rlo[R][W], rhi[R][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int l = l0 + r * T;
        const bool in = l < L;
        const size_t o = (size_t)(in ? l : 0) * W;
        if (vec) {
#pragma unroll
            for (int c = 0; c < W; c += 4) {
                float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
                if (in) {
                    a = *reinterpret_cast<const float4*>(lo + o + c);
                    b = *reinterpret_cast<const float4*>(hi + o + c);
                }
                rlo[r][c] = a.x; rlo[r][c + 1] = a.y;
                rlo[r][c + 2] = a.z; rlo[r][c + 3] = a.w;
                rhi[r][c] = b.x; rhi[r][c + 1] = b.y;
                rhi[r][c + 2] = b.z; rhi[r][c + 3] = b.w;
            }
        } else {
#pragma unroll
            for (int c = 0; c < W; ++c) {
                rlo[r][c] = in ? lo[o + c] : 0.f;
                rhi[r][c] = in ? hi[o + c] : 0.f;
            }
        }
    }
    const int nq = min(qpb, Q - q0);
    for (int i = tid; i < qpb * W; i += T) {
        const bool in = i < nq * W;
        const size_t g = (size_t)q0 * W + i;
        qs[i] = make_float2(in ? seg_lo[g] : 0.f, in ? seg_hi[g] : 0.f);
    }
    __syncthreads();

    for (int g = 0; g < nq; g += QI) {
        float acc[QI][R] = {};
        group<W>(qs + g * W, rlo, rhi, acc);
        store(out, acc, Q, L, q0 + g, l0, T, scale);
    }
}

// any w: QI queries a block, the columns in chunks of JC through shared
// memory (queries) and registers (leaves), zero-filled past w
__global__ void __launch_bounds__(64, 8)
lb_paa_interval_any_kernel(const float* __restrict__ seg_lo,
                           const float* __restrict__ seg_hi,
                           const float* __restrict__ lo,
                           const float* __restrict__ hi,
                           float* __restrict__ out, int Q, int L, int w,
                           float scale, int tiles_l) {
    __shared__ __align__(16) float2 qs[QI * JC];
    const int T = blockDim.x, tid = threadIdx.x;
    const int l0 = (int)(blockIdx.x % tiles_l) * (R * T) + tid;
    const int q0 = (int)(blockIdx.x / tiles_l) * QI;

    float acc[QI][R] = {};
    for (int j0 = 0; j0 < w; j0 += JC) {
        float rlo[R][JC], rhi[R][JC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int l = l0 + r * T;
#pragma unroll
            for (int c = 0; c < JC; ++c) {
                const bool in = l < L && j0 + c < w;
                const size_t g = (size_t)(in ? l : 0) * w + j0 + c;
                rlo[r][c] = in ? lo[g] : 0.f;
                rhi[r][c] = in ? hi[g] : 0.f;
            }
        }
        __syncthreads();              // the last chunk's readers are done
        for (int i = tid; i < QI * JC; i += T) {
            const int q = q0 + i / JC, j = j0 + i % JC;
            const bool in = q < Q && j < w;
            const size_t g = (size_t)(in ? q : 0) * w + (in ? j : 0);
            qs[i] = make_float2(in ? seg_lo[g] : 0.f, in ? seg_hi[g] : 0.f);
        }
        __syncthreads();
        group<JC>(qs, rlo, rhi, acc);
    }
    store(out, acc, Q, L, q0, l0, T, scale);
}

int sm_count(int dev) {
    static int sms[64];
    if (sms[dev & 63] == 0) {
        int n = 0;
        const cudaError_t e = cudaDeviceGetAttribute(
            &n, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return -(int)e;
        sms[dev & 63] = n;
    }
    return sms[dev & 63];
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int dumpy_lb_paa_interval_f32(const void* seg_lo, const void* seg_hi,
                                         const void* lo, const void* hi,
                                         void* out, int Q, int L, int w,
                                         float scale, void* stream) {
    if (Q <= 0 || L <= 0) return 0;
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const int sms = sm_count(dev);
    if (sms < 0) return -sms;
    const auto st = (cudaStream_t)stream;
    const auto* sl = (const float*)seg_lo;
    const auto* sh = (const float*)seg_hi;
    const auto* lf = (const float*)lo;
    const auto* hf = (const float*)hi;
    auto* of = (float*)out;
    const bool fixed = w == 8 || w == 16;
    // queries a block: grow from QI while 8 blocks an SM remain (fixed
    // widths only); 32 threads a block where 64 leave SMs without one
    int T = 64, qpb = QI;
    while (fixed && 2 * qpb <= QPB_MAX
           && cdiv(L, R * T) * cdiv(Q, 2 * qpb) >= 8LL * sms)
        qpb *= 2;
    if (cdiv(L, R * T) * cdiv(Q, qpb) < sms) T = 32;
    const long long tiles_l = cdiv(L, R * T);
    const long long blocks = tiles_l * cdiv(Q, qpb);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    if (!fixed) {
        lb_paa_interval_any_kernel<<<(unsigned)blocks, T, 0, st>>>(
            sl, sh, lf, hf, of, Q, L, w, scale, (int)tiles_l);
        return (int)cudaGetLastError();
    }
    const bool vec = (((uintptr_t)lo | (uintptr_t)hi) & 15) == 0;
    const size_t smem = (size_t)qpb * w * sizeof(float2);
    if (w == 8)
        lb_paa_interval_kernel<8><<<(unsigned)blocks, T, smem, st>>>(
            sl, sh, lf, hf, of, Q, L, scale, qpb, (int)tiles_l, vec);
    else
        lb_paa_interval_kernel<16><<<(unsigned)blocks, T, smem, st>>>(
            sl, sh, lf, hf, of, Q, L, scale, qpb, (int)tiles_l, vec);
    return (int)cudaGetLastError();
}
