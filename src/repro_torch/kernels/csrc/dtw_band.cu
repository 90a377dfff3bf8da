// Masked banded DTW^2 with cutoff early-abandon (the DP of the exact-DTW
// search) for Hopper (sm_90a).  Replaces the TPU kernel
// repro/kernels/dtw_band.py::dtw_band (body _kernel).
//
// qs [Q, n]; candidates either x [m, n] shared by every query
// (x_qstride = 0), x [Q, m, n] (x_qstride = m), or rows idx[q, l] of a
// collection x [T, n] (idx [Q, m] int64, non-null); mask [Q, m] bool,
// cutoff2 [Q] f32 -> out [Q, m] f32: the squared Sakoe-Chiba DTW of radius
// r, or +inf where the mask is off or the lane was abandoned.  Any r >= 0
// and n >= 1: r is cut to n-1 first (the same cells).
//
// A cell is
//     D(i, j) = fl32(fl64(c*c + min(D(i-1,j), D(i,j-1), D(i-1,j-1))))
// with c the f32 difference x[j] - q[i]: one rounding of the sum, as the
// reference's compiled DP (a fused multiply-add) and the plain version
// (repro_torch.core.lb._dtw2_masked_scan, f64) both do; no contraction is
// left to the compiler.  Since min is exact, every value equals the plain
// version's bit for bit.  Abandonment follows the plain version's rule: a
// lane is dead once the min over its last two anti-diagonals exceeds
// cutoff2.  That min never decreases from one diagonal to the next (each
// cell is >= its predecessors, costs are >= 0, rounding is monotone), so
// testing it every TEST_EVERY diagonals and on the last one gives the same
// set of +inf lanes as testing every diagonal.
//
// One warp per (query, candidate) lane; masked lanes write +inf and do no
// work.  The time is the latency of the 2n-1 dependent anti-diagonal steps
// of each lane (a few hundred live warps on the search's calls), not bytes:
// each lane reads its two rows (2n floats) once.  Two paths:
//
// * Register path, 2r+1 <= 64 (the search's r = 25).  Cell (i, j) sits at
//   band offset k = j - i + r in [0, 2r] of diagonal d = i + j; only
//   offsets k = d + r (mod 2) hold cells, so with p = (d + r) & 1 thread t
//   computes offset k = 2t + p.  Each thread keeps two registers: c1, its
//   cell on d-1 (offset 2t+1-p), and c2, its cell on d-2 (offset 2t+p).
//   The diagonal neighbour is its own c2; for p = 0 "up" is its own c1 and
//   "left" thread t-1's c1, for p = 1 "left" is its own c1 and "up" thread
//   t+1's c1: one __shfl_sync a diagonal is the whole exchange (+inf past
//   the warp's edge), with no shared frontier and no warp barrier.  Both
//   rows are staged once in the warp's shared memory (global reads where
//   2n floats a warp do not fit), so nothing on the chain reads device
//   memory.  The two-diagonal min is one __reduce_min_sync over the cells'
//   bit patterns (non-negative floats order like unsigned ints).  The
//   final cell (n-1, n-1) is on thread (r - (r & 1)) / 2.
// * Wide path, 2r+1 > 64: a band-compacted frontier of Wb = r+1 slots per
//   diagonal (slot o of diagonal d is column j = base(d) + o, base(d) =
//   clip(ceil((d-r)/2), 0, n-1-r); all n columns when r + 1 >= n), three
//   diagonals with +inf pad slots, in the warp's shared memory while they
//   fit and otherwise in a device scratch buffer that the wrapper
//   allocates (dumpy_dtw_band_scratch_floats says how large); lane t owns
//   slots t, t+32, ...  Slow, and kept for bands the search does not use.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int TEST_EVERY = 8;
constexpr int REG_BAND = 64;          // the register path: 2r+1 <= 64
constexpr int MAX_DEV = 64;
constexpr unsigned FULL = 0xffffffffu;

template <bool STAGED>
__global__ void __launch_bounds__(WARPS * 32)
dtw_band_reg_kernel(const float* __restrict__ qs,
                    const float* __restrict__ xs,
                    const long long* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ cutoff2,
                    float* __restrict__ out, int Q, int m, int n, int r,
                    long long x_qstride) {
    extern __shared__ float sm[];
    const float INF = __int_as_float(0x7f800000);
    const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * WARPS + warp;
    if (g >= (long long)Q * m) return;
    const int tfin = (r - (r & 1)) >> 1;   // holds (n-1, n-1) at the end
    if (!mask[g]) {
        if (t == tfin) out[g] = INF;
        return;
    }
    const int q = (int)(g / m);
    const int l = (int)(g - (long long)q * m);
    const long long row = idx ? idx[g] : (long long)q * x_qstride + l;
    const float* xr = xs + row * n;
    const float* qr = qs + (size_t)q * n;
    if (STAGED) {
        float* sx = sm + (size_t)warp * 2 * n;
        float* sq = sx + n;
        for (int o = t; o < n; o += 32) {
            sx[o] = __ldg(xr + o);
            sq[o] = __ldg(qr + o);
        }
        __syncwarp();
        xr = sx;
        qr = sq;
    }
    const float cut = cutoff2[q];
    // c2 of the final thread at d = 0 is the "cell (-1, -1)": 0 makes
    // best = 0 at (0, 0); every other thread's cell on d = 0 is off the
    // matrix
    float c1 = INF, c2 = t == tfin ? 0.f : INF;
    const int last = 2 * n - 2, kmax = 2 * r;
    bool alive = true;
    for (int d = 0; d <= last; ++d) {
        const int p = (d + r) & 1;
        const int k = 2 * t + p;
        const int i = (d - k + r) >> 1, j = (d + k - r) >> 1;
        const bool valid = k <= kmax && i >= 0 && i < n && j >= 0 && j < n;
        // the cost is off the chain: it depends on d alone
        const float xv = xr[min(max(j, 0), n - 1)];
        const float qv = qr[min(max(i, 0), n - 1)];
        const double c = (double)__fsub_rn(xv, qv);
        const double cc = __dmul_rn(c, c);
        const float own = fminf(c1, c2);   // up (p = 0) or left, and diag
        const int src = t - 1 + 2 * p;     // left (p = 0) or up (p = 1)
        float nb = __shfl_sync(FULL, c1, src & 31);
        if ((unsigned)src > 31u) nb = INF;
        const float best = fminf(own, nb);
        const float v = valid
            ? __double2float_rn(__dadd_rn(cc, (double)best)) : INF;
        const float lmin = fminf(v, c1);
        c2 = c1;
        c1 = v;
        if ((d & (TEST_EVERY - 1)) == TEST_EVERY - 1 || d == last) {
            const unsigned mn = __reduce_min_sync(FULL, __float_as_uint(lmin));
            if (!(__uint_as_float(mn) <= cut)) { alive = false; break; }
        }
    }
    if (t == tfin) out[g] = alive ? c1 : INF;
}

__device__ __forceinline__ int dtw_base(int d, int r, int n, bool full) {
    if (full) return 0;
    // ceil((d - r) / 2) = (d - r + 1) / 2 for d - r + 1 >= 0; anything
    // negative clamps to 0 either way
    return min(max((d - r + 1) / 2, 0), n - 1 - r);
}

// the wide path: lanes g = warp, warp + grid·WARPS, ... (one pass where
// the grid covers every lane); the frontier in shared memory, or at
// scratch[(blockIdx.x·WARPS + warp)·3·(Wb + 3)] when scratch is non-null
__global__ void __launch_bounds__(WARPS * 32)
dtw_band_kernel(const float* __restrict__ qs, const float* __restrict__ xs,
                const long long* __restrict__ idx,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ cutoff2, float* __restrict__ out,
                float* __restrict__ scratch, int Q, int m, int n, int r,
                long long x_qstride) {
    extern __shared__ float sm[];
    const float INF = __int_as_float(0x7f800000);
    const bool full = r + 1 >= n;
    const int Wb = full ? n : r + 1;
    const int stride = Wb + 3;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long wid = (long long)blockIdx.x * WARPS + warp;
    float* const fr = scratch ? scratch + wid * 3 * stride
                              : sm + warp * 3 * stride;
    const int last = 2 * n - 2;
    for (long long g = wid; g < (long long)Q * m;
         g += (long long)gridDim.x * WARPS) {
        if (!mask[g]) {
            if (lane == 0) out[g] = INF;
            continue;
        }
        const int q = (int)(g / m);
        const int l = (int)(g - (long long)q * m);
        const long long row = idx ? idx[g] : (long long)q * x_qstride + l;
        const float* x = xs + row * n;
        const float* qq = qs + (size_t)q * n;
        const float cut = cutoff2[q];

        // slot o of a diagonal sits at buf[1 + o]; buf[0], buf[Wb+1],
        // buf[Wb+2] stay +inf (the out-of-frontier neighbours)
        float* p2 = fr;                     // diagonal d-2
        float* p1 = p2 + stride;            // diagonal d-1
        float* p0 = p1 + stride;            // diagonal d
        __syncwarp();                       // the last lane's read is done
        for (int o = lane; o < 3 * stride; o += 32) p2[o] = INF;
        __syncwarp();

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
                    const double c =
                        (double)__fsub_rn(__ldg(x + j), __ldg(qq + i));
                    v = __double2float_rn(
                        __dadd_rn(__dmul_rn(c, c), (double)best));
                }
                p0[1 + o] = v;
                lmin = fminf(lmin, fminf(v, p1[1 + o]));
            }
            __syncwarp();
            float* tmp = p2;  p2 = p1;  p1 = p0;  p0 = tmp;
            b2 = b1;  b1 = b;
            if (d % TEST_EVERY == TEST_EVERY - 1 || d == last) {
                for (int o = 16; o > 0; o >>= 1)
                    lmin = fminf(lmin, __shfl_xor_sync(FULL, lmin, o));
                if (!(lmin <= cut)) { alive = false; break; }
            }
        }
        if (lane == 0) {
            const int slot =
                full ? n - 1 : (n - 1) - dtw_base(last, r, n, full);
            out[g] = alive ? p1[1 + slot] : INF;
        }
    }
}

struct Device {            // per device, read once
    int sms = 0;
    int smem_optin = 0;    // the most dynamic shared memory a block may ask
    int smem_set[3] = {};  // the limit raised so far, per kernel
};
Device devices[MAX_DEV];

struct Plan {
    int kernel;            // 0: register, rows in global; 1: register,
                           // rows staged; 2: wide
    size_t smem;           // dynamic shared memory a block
    unsigned grid;
    long long scratch;     // floats of frontier scratch (wide path), or 0
};

int plan(int Q, int m, int n, int r, Device*& dv, Plan& p) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    dv = &devices[dev & (MAX_DEV - 1)];
    if (dv->sms == 0) {
        e = cudaDeviceGetAttribute(&dv->smem_optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&dv->sms,
                                       cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) { dv->sms = 0; return (int)e; }
    }
    const long long lanes = (long long)Q * m;
    const long long blocks = (lanes + WARPS - 1) / WARPS;
    if (2 * r + 1 <= REG_BAND) {
        const size_t rows = (size_t)WARPS * 2 * n * sizeof(float);
        const bool staged = rows <= (size_t)dv->smem_optin;
        p = {staged ? 1 : 0, staged ? rows : 0, (unsigned)blocks, 0};
        return 0;
    }
    const int Wb = r + 1 >= n ? n : r + 1;
    const size_t front = (size_t)WARPS * 3 * (Wb + 3) * sizeof(float);
    if (front <= (size_t)dv->smem_optin) {
        p = {2, front, (unsigned)blocks, 0};
    } else {               // a bounded grid walks the lanes
        const long long grid = blocks < 2LL * dv->sms ? blocks
                                                       : 2LL * dv->sms;
        p = {2, 0, (unsigned)grid, grid * WARPS * 3 * (Wb + 3)};
    }
    return 0;
}

template <typename K>
int raise_smem(K kernel, Device* dv, int which, size_t smem) {
    if (smem <= 48 * 1024 || (int)smem <= dv->smem_set[which]) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dv->smem_set[which] = (int)smem;
    return 0;
}

}  // namespace

// floats of device scratch the wide path needs for this call (0 when its
// frontier fits in shared memory, or on the register path)
extern "C" int dumpy_dtw_band_scratch_floats(int Q, int m, int n, int r,
                                             long long* floats) {
    if (r > n - 1) r = n - 1;
    Device* dv;
    Plan p;
    const int e = plan(Q, m, n, r, dv, p);
    *floats = e ? 0 : p.scratch;
    return e;
}

extern "C" int dumpy_dtw_band_f32(const void* qs, const void* xs,
                                  const void* idx, const void* mask,
                                  const void* cutoff2, void* out,
                                  void* scratch, int Q, int m, int n, int r,
                                  long long x_qstride, void* stream) {
    if (r > n - 1) r = n - 1;         // the same cells
    Device* dv;
    Plan p;
    int e = plan(Q, m, n, r, dv, p);
    if (e) return e;
    if (p.scratch && !scratch) return (int)cudaErrorInvalidValue;
    const auto st = (cudaStream_t)stream;
    const auto* q = (const float*)qs;
    const auto* x = (const float*)xs;
    const auto* ix = (const long long*)idx;
    const auto* mk = (const unsigned char*)mask;
    const auto* ct = (const float*)cutoff2;
    auto* o = (float*)out;
    switch (p.kernel) {
    case 0:
        dtw_band_reg_kernel<false><<<p.grid, WARPS * 32, 0, st>>>(
            q, x, ix, mk, ct, o, Q, m, n, r, x_qstride);
        break;
    case 1:
        e = raise_smem(dtw_band_reg_kernel<true>, dv, 1, p.smem);
        if (e) return e;
        dtw_band_reg_kernel<true><<<p.grid, WARPS * 32, p.smem, st>>>(
            q, x, ix, mk, ct, o, Q, m, n, r, x_qstride);
        break;
    default:
        e = raise_smem(dtw_band_kernel, dv, 2, p.smem);
        if (e) return e;
        dtw_band_kernel<<<p.grid, WARPS * 32, p.smem, st>>>(
            q, x, ix, mk, ct, o, p.scratch ? (float*)scratch : nullptr, Q,
            m, n, r, x_qstride);
    }
    return (int)cudaGetLastError();
}
