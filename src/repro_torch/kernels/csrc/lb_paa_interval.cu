// Squared interval MINDIST (the exact-search pruning scan) for Hopper
// (sm_90a).
//
// seg_lo / seg_hi [Q, w] query intervals, lo / hi [L, w] region bounds, all
// f32 row-major -> out [Q, L] f32 with
//     out[q, l] = scale * sum_j max(lo[l,j] - seg_hi[q,j], seg_lo[q,j] - hi[l,j], 0)^2
// summed over j in order, scale = n / w.
//
// Each block stages a tile of TL leaves (coalesced, row stride w+1 so the
// per-thread reads are bank-conflict free) and the intervals of TQ queries
// in shared memory; each thread owns one leaf and writes its TQ bounds, so
// stores along L are coalesced.  Leaves bounded by +inf (the pad leaf of
// every shard) give +inf: max(+inf - qhi, 0) = +inf and
// max(qlo - +inf, 0) = 0, never NaN.
#include <cuda_runtime.h>

namespace {

constexpr int TL = 128;   // leaves per block (= threads)
constexpr int TQ = 8;     // queries per block

__global__ void __launch_bounds__(TL)
lb_paa_interval_kernel(const float* __restrict__ seg_lo,
                       const float* __restrict__ seg_hi,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi,
                       float* __restrict__ out,
                       int Q, int L, int w, float scale) {
    extern __shared__ float sm[];
    const int ws = w + 1;
    float* lo_s = sm;                  // [TL][w+1]
    float* hi_s = lo_s + TL * ws;      // [TL][w+1]
    float* qlo_s = hi_s + TL * ws;     // [TQ][w]
    float* qhi_s = qlo_s + TQ * w;     // [TQ][w]

    const int l0 = blockIdx.x * TL;
    const int qb = blockIdx.y * TQ;
    for (int i = threadIdx.x; i < TL * w; i += TL) {
        const int r = i / w, c = i - r * w;
        const int gl = l0 + r;
        const bool ok = gl < L;
        lo_s[r * ws + c] = ok ? lo[(size_t)gl * w + c] : 0.f;
        hi_s[r * ws + c] = ok ? hi[(size_t)gl * w + c] : 0.f;
    }
    for (int i = threadIdx.x; i < TQ * w; i += TL) {
        const int r = i / w, c = i - r * w;
        const int gq = qb + r;
        const bool ok = gq < Q;
        qlo_s[i] = ok ? seg_lo[(size_t)gq * w + c] : 0.f;
        qhi_s[i] = ok ? seg_hi[(size_t)gq * w + c] : 0.f;
    }
    __syncthreads();

    const int l = l0 + threadIdx.x;
    if (l >= L) return;
    const float* lr = lo_s + threadIdx.x * ws;
    const float* hr = hi_s + threadIdx.x * ws;
    for (int qi = 0; qi < TQ; ++qi) {
        const int gq = qb + qi;
        if (gq >= Q) break;
        const float* ql = qlo_s + qi * w;
        const float* qh = qhi_s + qi * w;
        float acc = 0.f;
        for (int j = 0; j < w; ++j) {
            const float below = fmaxf(__fsub_rn(lr[j], qh[j]), 0.f);
            const float above = fmaxf(__fsub_rn(ql[j], hr[j]), 0.f);
            const float d = fmaxf(below, above);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        out[(size_t)gq * L + l] = __fmul_rn(scale, acc);
    }
}

}  // namespace

extern "C" int dumpy_lb_paa_interval_f32(const void* seg_lo, const void* seg_hi,
                                         const void* lo, const void* hi,
                                         void* out, int Q, int L, int w,
                                         float scale, void* stream) {
    dim3 grid((L + TL - 1) / TL, (Q + TQ - 1) / TQ);
    const size_t smem = (size_t)(2 * TL * (w + 1) + 2 * TQ * w) * sizeof(float);
    lb_paa_interval_kernel<<<grid, TL, smem, (cudaStream_t)stream>>>(
        (const float*)seg_lo, (const float*)seg_hi, (const float*)lo,
        (const float*)hi, (float*)out, Q, L, w, scale);
    return (int)cudaGetLastError();
}
