// Fused PAA + SAX symbolization for Hopper (sm_90a).  Replaces the TPU
// kernel src/repro/kernels/sax_encode.py::sax_encode (body _kernel).
//
// x [B, n] f32 (row-major, contiguous) -> paa [B, w] f32, sax [B, w] i32.
// PAA is the segment mean: the seg = n / w values of a segment summed in
// order from +0 (__fadd_rn), divided by seg (__fdiv_rn); the symbol is the
// number of breakpoints not above it, found by the binary search of
// torch.searchsorted(bp, paa, right=True) over the c - 1 breakpoints in
// shared memory (the same predicate, so a NaN mean gets c - 1 as there).
//
// What bounds it: one pass over x (B·n·4 bytes) for B·n adds.  At the
// query batch [64, 256] that is 64 KB, below one launch; over a collection
// (a 4 M x 256 shard, 4.2 GB) it is device memory.  The design:
//
//   - The rows are a run of B·w segments of seg floats.  A block of 256
//     threads takes a tile of 256 consecutive segments, one a thread, and
//     stages it in shared memory with cp.async: 16-byte copies where seg
//     is a multiple of 4 and x is 16-byte aligned, else a 4-byte instance
//     (a template parameter) with the same layout and the same sums.
//     Neighbouring threads copy neighbouring addresses.
//   - A segment sits at a padded stride of SP copy units, SP odd, so the
//     32 segments a warp sums fall in 32 banks (4-byte reads) or the 8 of
//     each quarter warp in 8 bank groups (16-byte reads, the hot case).
//   - One wave of blocks, two an SM, walks the tiles (tile = block + k ·
//     grid); a ring of NS = 4 stages keeps three tiles of copies in flight
//     behind the one being summed.
//   - A stage holds at most 16 floats of each segment; a longer segment
//     is summed over several stages in order, the sum kept in a register,
//     so no length is refused.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // segments a tile, one a thread
constexpr int NS = 4;          // stages in the ring
constexpr int SC = 16;         // floats of each segment a stage holds

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

// the padded stride of a staged segment, in copy units of V floats: odd
__host__ __device__ constexpr int seg_stride(int V) {
    return (SC / V + 1) | 1;
}

template <int V>
constexpr int smem_floats(int nbp) {
    return NS * THREADS * seg_stride(V) * V + nbp;
}

// Stage columns [c0, c0 + width) of the tile's segments p0 .. p0+255
// into a ring slot: unit u of segment p at (p · SP + u) · V floats.
template <int V>
__device__ __forceinline__ void load_stage(float* slot, const float* x,
                                           long long pairs, int seg,
                                           long long p0, int c0, int width,
                                           int tid) {
    // a full chunk's units are known at compile time: no division
    const int units = width == SC ? SC / V : width / V;
    for (int idx = tid; idx < THREADS * units; idx += THREADS) {
        const int p = width == SC ? idx / (SC / V) : idx / units;
        const int u = idx - p * units;
        const bool in = p0 + p < pairs;
        const float* src = in ? x + (p0 + p) * seg + c0 + u * V : x;
        float* dst = slot + (p * seg_stride(V) + u) * V;
        if (V == 4) cp_async16(dst, src, in);
        else cp_async4(dst, src, in);
    }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 2)
sax_encode_kernel(const float* __restrict__ x, const float* __restrict__ bp,
                  float* __restrict__ paa, int32_t* __restrict__ sax,
                  long long pairs, int seg, int nbp) {
    constexpr int SP = seg_stride(V), STAGE = THREADS * SP * V;
    extern __shared__ __align__(16) float smem[];
    float* s_bp = smem + NS * STAGE;
    const int tid = threadIdx.x;
    // tiles, and the (tile, chunk) items of this block: tile blockIdx.x +
    // (k / chunks) · gridDim.x, columns from (k % chunks) · SC; both fit 32
    // bits for any x that fits in device memory, and 32-bit division keeps
    // the first copies early
    const int tiles = (int)((pairs + THREADS - 1) / THREADS);
    const int chunks = seg > 0 ? (seg + SC - 1) / SC : 1;  // stages a segment
    const int items =
        (int)((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * chunks;
    auto tile_of = [&](int k) {
        return blockIdx.x + (long long)(k / chunks) * gridDim.x;
    };
    auto issue = [&](int k) {
        const int c0 = (k % chunks) * SC;
        load_stage<V>(smem + (k % NS) * STAGE, x, pairs, seg,
                      tile_of(k) * THREADS, c0, min(SC, seg - c0), tid);
    };
    for (int k = 0; k < NS - 1; ++k) {
        if (k < items) issue(k);
        cp_async_commit();
    }
    for (int i = tid; i < nbp; i += THREADS) s_bp[i] = bp[i];

    const float seg_len = (float)seg;
    float s = 0.f;
    for (int k = 0; k < items; ++k) {
        if (k + NS - 1 < items) issue(k + NS - 1);
        cp_async_commit();
        cp_async_wait<NS - 1>();
        __syncthreads();              // stage k has landed for every thread
        const int c = k % chunks;
        const int units = min(SC, seg - c * SC) / V;
        const float* mine = smem + (k % NS) * STAGE + tid * SP * V;
        if (c == 0) s = 0.f;
        if (V == 4) {
            for (int u = 0; u < units; ++u) {
                const float4 v = reinterpret_cast<const float4*>(mine)[u];
                s = __fadd_rn(s, v.x);
                s = __fadd_rn(s, v.y);
                s = __fadd_rn(s, v.z);
                s = __fadd_rn(s, v.w);
            }
        } else {
            for (int u = 0; u < units; ++u) s = __fadd_rn(s, mine[u]);
        }
        const long long P = tile_of(k) * THREADS + tid;
        if (c == chunks - 1 && P < pairs) {
            const float m = __fdiv_rn(s, seg_len);
            paa[P] = m;
            int lo = 0, hi = nbp;         // searchsorted(bp, m, right=True)
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (!(s_bp[mid] > m)) lo = mid + 1; else hi = mid;
            }
            sax[P] = lo;
        }
        __syncthreads();              // stage k read: its slot may refill
    }
}

template <int V>
int launch(const float* x, const float* bp, float* paa, int32_t* sax,
           long long pairs, int seg, int nbp, cudaStream_t stream) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    static int sms[64];
    if (sms[dev & 63] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev & 63],
                                   cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
    }
    // the attribute belongs to the current device: raised once per device
    // to the largest table (b = 12)
    static bool attr_set[64];
    if (!attr_set[dev & 63]) {
        e = cudaFuncSetAttribute(
            sax_encode_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_floats<V>(4095) * (int)sizeof(float));
        if (e != cudaSuccess) return (int)e;
        attr_set[dev & 63] = true;
    }
    const long long tiles = (pairs + THREADS - 1) / THREADS;
    const long long blocks = tiles < 2LL * sms[dev & 63] ? tiles
                                                        : 2LL * sms[dev & 63];
    sax_encode_kernel<V><<<(unsigned)blocks, THREADS,
                           smem_floats<V>(nbp) * sizeof(float), stream>>>(
        x, bp, paa, sax, pairs, seg, nbp);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dumpy_sax_encode_f32(const void* x, const void* bp, void* paa,
                                    void* sax, int B, int n, int w, int nbp,
                                    void* stream) {
    if (B <= 0 || w <= 0) return 0;
    if (nbp > 4095) return (int)cudaErrorInvalidValue;
    const long long pairs = (long long)B * w;
    const int seg = n / w;
    const auto* xf = (const float*)x;
    const auto st = (cudaStream_t)stream;
    if (seg % 4 == 0 && ((uintptr_t)x & 15) == 0)
        return launch<4>(xf, (const float*)bp, (float*)paa, (int32_t*)sax,
                         pairs, seg, nbp, st);
    return launch<1>(xf, (const float*)bp, (float*)paa, (int32_t*)sax, pairs,
                     seg, nbp, st);
}
