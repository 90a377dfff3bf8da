// Squared LB_Keogh of candidates against query envelopes (stage 1 of the
// exact-DTW candidate cascade) for Hopper (sm_90a).
//
// x [m, n] (one candidate block shared by every query, x_qstride = 0) or
// x [Q, m, n] (a candidate set per query, x_qstride = m), U / L [Q, n], all
// f32 row-major -> out [Q, m] f32 with
//     out[q, l] = sum_i max(max(x[l,i] - U[q,i], 0), max(L[q,i] - x[l,i], 0))^2
//
// One block per candidate row, one warp per (query, candidate) pair: the
// lanes walk the row (coalesced), the pair's sum is a warp reduction.  In
// the shared layout the block stages its candidate row in shared memory once
// and its eight warps walk the queries of the block against it.  The work is
// ~7 float32 operations per element against 4 bytes of candidate read once,
// so at the search's shapes (64 queries per row) it is bound by operations.
// Edge envelopes may be infinite (U = +inf, L = -inf): max(x - inf, 0) = 0
// and max(-inf - x, 0) = 0, never NaN.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;    // warps per block
constexpr int QPB = 64;     // queries per block (grid.y covers the rest)

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__global__ void __launch_bounds__(WARPS * 32)
lb_keogh_kernel(const float* __restrict__ x, const float* __restrict__ U,
                const float* __restrict__ L, float* __restrict__ out,
                int Q, int m, int n, long long x_qstride) {
    extern __shared__ float x_s[];                    // [n] (shared layout)
    const int l = blockIdx.x;
    const int q0 = blockIdx.y * QPB;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool shared = x_qstride == 0;
    if (shared) {
        const float* row = x + (size_t)l * n;
        for (int i = threadIdx.x; i < n; i += blockDim.x) x_s[i] = row[i];
        __syncthreads();
    }
    const int qend = min(Q, q0 + QPB);
    for (int q = q0 + warp; q < qend; q += WARPS) {
        const float* xr = shared ? x_s : x + ((size_t)q * x_qstride + l) * n;
        const float* u = U + (size_t)q * n;
        const float* lo = L + (size_t)q * n;
        float acc = 0.f;
        for (int i = lane; i < n; i += 32) {
            const float xv = xr[i];
            const float above = fmaxf(__fsub_rn(xv, __ldg(u + i)), 0.f);
            const float below = fmaxf(__fsub_rn(__ldg(lo + i), xv), 0.f);
            const float d = fmaxf(above, below);
            acc = __fadd_rn(acc, __fmul_rn(d, d));
        }
        acc = warp_sum(acc);
        if (lane == 0) out[(size_t)q * m + l] = acc;
    }
}

}  // namespace

extern "C" int dumpy_lb_keogh_f32(const void* x, const void* U, const void* L,
                                  void* out, int Q, int m, int n,
                                  long long x_qstride, void* stream) {
    dim3 grid(m, (Q + QPB - 1) / QPB);
    const size_t smem = x_qstride == 0 ? (size_t)n * sizeof(float) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lb_keogh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    lb_keogh_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)U, (const float*)L, (float*)out, Q, m,
        n, x_qstride);
    return (int)cudaGetLastError();
}
