// Squared LB_Improved (Lemire 2009; stage 2 of the exact-DTW candidate
// cascade) for Hopper (sm_90a).
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
// per (query, candidate) pair.  One warp owns a pair: it writes h into a
// per-warp row of shared memory padded with r cells of -inf (max row) and
// +inf (min row) on each side, then computes the max / min over every
// window of k = 2^floor(log2(2r+1)) cells by log2(k) in-place doubling
// passes (max(M_s[p], M_s[p+s]), each pass ~(n+2r)/32 steps per lane), and
// reads the window [i-r, i+r] as the max of two overlapping k-windows.
// That is O(n log r) per pair instead of the naive O(n r), and exact (max
// and min do not round).  One block per candidate row: in the shared layout
// the row is staged in shared memory once and reused by every query of the
// block.  Bound by operations (~20 per element) at the search's shapes.
// The two sums are taken per lane and then by a warp reduction: another
// order than the plain version's, so the result agrees to a few ulps.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int QPB = 64;

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(WARPS * 32)
lb_improved_kernel(const float* __restrict__ x, const float* __restrict__ qs,
                   const float* __restrict__ U, const float* __restrict__ L,
                   float* __restrict__ out, int Q, int m, int n, int r,
                   long long x_qstride) {
    extern __shared__ float sm[];
    const float INF = __int_as_float(0x7f800000);
    const int P = n + 2 * r;                 // padded window row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool shared = x_qstride == 0;
    const int xs_len = shared ? n : 0;
    float* x_s = sm;                                  // [n] (shared layout)
    float* A = sm + xs_len + warp * 2 * P;            // [P] running max
    float* B = A + P;                                 // [P] running min
    const int l = blockIdx.x;
    const int q0 = blockIdx.y * QPB;
    if (shared) {
        const float* row = x + (size_t)l * n;
        for (int i = threadIdx.x; i < n; i += blockDim.x) x_s[i] = row[i];
        __syncthreads();
    }
    const int W = 2 * r + 1;
    int k = 1;
    while (2 * k <= W) k <<= 1;
    const int qend = min(Q, q0 + QPB);
    for (int q = q0 + warp; q < qend; q += WARPS) {
        const float* xr = shared ? x_s : x + ((size_t)q * x_qstride + l) * n;
        const float* u = U + (size_t)q * n;
        const float* lo = L + (size_t)q * n;
        const float* qq = qs + (size_t)q * n;
        for (int p = lane; p < r; p += 32) {
            A[p] = -INF;  B[p] = INF;
            A[r + n + p] = -INF;  B[r + n + p] = INF;
        }
        float acc1 = 0.f;
        for (int i = lane; i < n; i += 32) {
            const float xv = xr[i];
            const float uv = __ldg(u + i), lv = __ldg(lo + i);
            const float above = fmaxf(__fsub_rn(xv, uv), 0.f);
            const float below = fmaxf(__fsub_rn(lv, xv), 0.f);
            const float d1 = fmaxf(above, below);
            acc1 = __fadd_rn(acc1, __fmul_rn(d1, d1));
            const float h = fminf(fmaxf(xv, lv), uv);
            A[r + i] = h;
            B[r + i] = h;
        }
        __syncwarp();
        // doubling: after the pass of step s, A[p] = max A0[p .. p+2s-1]
        // for p < P-2s+1.  In place is safe: a lane reads p and p+s >= p,
        // and the steps of one pass walk p upward
        for (int s = 1; 2 * s <= k; s <<= 1) {
            const int cnt = P - 2 * s + 1;
            for (int p0 = 0; p0 < cnt; p0 += 32) {
                const int p = p0 + lane;
                float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
                if (p < cnt) { a0 = A[p]; a1 = A[p + s]; b0 = B[p]; b1 = B[p + s]; }
                __syncwarp();
                if (p < cnt) { A[p] = fmaxf(a0, a1); B[p] = fminf(b0, b1); }
                __syncwarp();
            }
        }
        const int off = W - k;                  // second k-window of [i, i+W)
        float acc2 = 0.f;
        for (int i = lane; i < n; i += 32) {
            const float uh = fmaxf(A[i], A[i + off]);
            const float lh = fminf(B[i], B[i + off]);
            const float qv = __ldg(qq + i);
            const float d2 = fmaxf(fmaxf(__fsub_rn(qv, uh), 0.f),
                                   fmaxf(__fsub_rn(lh, qv), 0.f));
            acc2 = __fadd_rn(acc2, __fmul_rn(d2, d2));
        }
        acc1 = warp_sum(acc1);
        acc2 = warp_sum(acc2);
        if (lane == 0) out[(size_t)q * m + l] = __fadd_rn(acc1, acc2);
        __syncwarp();                 // the next pair overwrites A and B
    }
}

}  // namespace

extern "C" int dumpy_lb_improved_f32(const void* x, const void* qs,
                                     const void* U, const void* L, void* out,
                                     int Q, int m, int n, int r,
                                     long long x_qstride, void* stream) {
    dim3 grid(m, (Q + QPB - 1) / QPB);
    const size_t smem = (size_t)((x_qstride == 0 ? n : 0)
                                 + WARPS * 2 * (n + 2 * r)) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lb_improved_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    lb_improved_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)qs, (const float*)U, (const float*)L,
        (float*)out, Q, m, n, r, x_qstride);
    return (int)cudaGetLastError();
}
