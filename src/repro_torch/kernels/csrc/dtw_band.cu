// Masked banded DTW^2 with cutoff early-abandon (the DP of the exact-DTW
// search) for Hopper (sm_90a).
//
// qs [Q, n]; candidates either x [m, n] shared by every query
// (x_qstride = 0), x [Q, m, n] (x_qstride = m), or rows idx[q, l] of a
// collection x [T, n] (idx [Q, m] int64, non-null); mask [Q, m] bool,
// cutoff2 [Q] f32 -> out [Q, m] f32: the squared Sakoe-Chiba DTW of radius
// r, or +inf where the mask is off or the lane was abandoned.
//
// The DP follows its plain version (repro_torch.core.lb._dtw2_masked_scan)
// cell for cell: it walks the 2n-1 anti-diagonals with a band-compacted
// frontier of Wb = r+1 slots (slot o of diagonal d is column
// j = base(d) + o, base(d) = clip(ceil((d-r)/2), 0, n-1-r)); when
// r + 1 >= n the frontier is all n columns (base = 0).  A cell is
//     D(i, j) = fl32(fl64(c*c + min(D(i-1,j), D(i,j-1), D(i-1,j-1))))
// with c the f32 difference x[j] - q[i]: one rounding of the sum, as the
// reference's compiled DP (a fused multiply-add) and the plain version (f64)
// both do, and no contraction is left to the compiler.  Since min is exact,
// the finite values equal the plain version's bit for bit.
//
// One warp per (query, candidate) lane: masked lanes write +inf and do no
// DP work.  The frontier (three diagonals, with +inf pad slots at -1 and
// Wb, Wb+1) lives in the warp's shared memory; lane t owns slots t, t+32, ...
// Abandonment follows the plain version's rule: a lane is dead once the min
// over its last two diagonals exceeds cutoff2.  That min never decreases
// from one diagonal to the next (each cell is >= its predecessors, costs
// are >= 0 and rounding is monotone), so testing it every TEST_EVERY
// diagonals and on the last one gives exactly the same set of +inf lanes
// as testing every diagonal; the warp-wide min is paid 1/TEST_EVERY as
// often.  The kernel is bound by the sequential chain of 2n-1 dependent
// diagonal steps per lane (latency), not by bytes: each lane reads its two
// rows (2n floats, cached) once.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int TEST_EVERY = 8;

__device__ __forceinline__ int dtw_base(int d, int r, int n, bool full) {
    if (full) return 0;
    // ceil((d - r) / 2) = (d - r + 1) / 2 for d - r + 1 >= 0; anything
    // negative clamps to 0 either way
    return min(max((d - r + 1) / 2, 0), n - 1 - r);
}

__global__ void __launch_bounds__(WARPS * 32)
dtw_band_kernel(const float* __restrict__ qs, const float* __restrict__ xs,
                const long long* __restrict__ idx,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ cutoff2, float* __restrict__ out,
                int Q, int m, int n, int r, long long x_qstride) {
    extern __shared__ float sm[];
    const float INF = __int_as_float(0x7f800000);
    const bool full = r + 1 >= n;
    const int Wb = full ? n : r + 1;
    const int stride = Wb + 3;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * WARPS + warp;
    if (g >= (long long)Q * m) return;
    if (!mask[g]) {
        if (lane == 0) out[g] = INF;
        return;
    }
    const int q = (int)(g / m);
    const int l = (int)(g - (long long)q * m);
    const long long row = idx ? idx[g] : (long long)q * x_qstride + l;
    const float* x = xs + row * n;
    const float* qq = qs + (size_t)q * n;
    const float cut = cutoff2[q];

    // slot o of a diagonal sits at buf[1 + o]; buf[0], buf[Wb+1], buf[Wb+2]
    // stay +inf (the out-of-frontier neighbours)
    float* p2 = sm + warp * 3 * stride;     // diagonal d-2
    float* p1 = p2 + stride;                // diagonal d-1
    float* p0 = p1 + stride;                // diagonal d
    for (int t = lane; t < 3 * stride; t += 32) p2[t] = INF;
    __syncwarp();

    const int last = 2 * n - 2;
    int b1 = dtw_base(-1, r, n, full), b2 = dtw_base(-2, r, n, full);
    bool alive = true;
    for (int d = 0; d <= last; ++d) {
        const int b = dtw_base(d, r, n, full);
        const int s1 = b - b1, s2 = b - b2;   // slot shifts vs d-1, d-2
        float lmin = INF;
        for (int o = lane; o < Wb; o += 32) {
            const int j = b + o, i = d - j;
            const float up = p1[1 + o + s1];  // D(i-1, j)
            const float left = p1[o + s1];    // D(i, j-1)
            const float dg = p2[o + s2];      // D(i-1, j-1)
            float best = fminf(fminf(up, left), dg);
            if (d == 0 && j == 0) best = 0.f;
            float v = INF;
            if (i >= 0 && i < n && j < n && abs(i - j) <= r) {
                const double c = (double)__fsub_rn(__ldg(x + j), __ldg(qq + i));
                v = __double2float_rn(__dadd_rn(__dmul_rn(c, c), (double)best));
            }
            p0[1 + o] = v;
            lmin = fminf(lmin, fminf(v, p1[1 + o]));
        }
        __syncwarp();
        float* t = p2;  p2 = p1;  p1 = p0;  p0 = t;
        b2 = b1;  b1 = b;
        if (d % TEST_EVERY == TEST_EVERY - 1 || d == last) {
            for (int o = 16; o > 0; o >>= 1)
                lmin = fminf(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
            if (!(lmin <= cut)) { alive = false; break; }
        }
    }
    if (lane == 0) {
        const int slot = full ? n - 1 : (n - 1) - dtw_base(last, r, n, full);
        out[g] = alive ? p1[1 + slot] : INF;
    }
}

}  // namespace

extern "C" int dumpy_dtw_band_f32(const void* qs, const void* xs,
                                  const void* idx, const void* mask,
                                  const void* cutoff2, void* out, int Q,
                                  int m, int n, int r, long long x_qstride,
                                  void* stream) {
    const long long lanes = (long long)Q * m;
    const unsigned grid = (unsigned)((lanes + WARPS - 1) / WARPS);
    const int Wb = r + 1 >= n ? n : r + 1;
    const size_t smem = (size_t)WARPS * 3 * (Wb + 3) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            dtw_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dtw_band_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)qs, (const float*)xs, (const long long*)idx,
        (const unsigned char*)mask, (const float*)cutoff2, (float*)out, Q, m,
        n, r, x_qstride);
    return (int)cudaGetLastError();
}
