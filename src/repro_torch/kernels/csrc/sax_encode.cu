// Fused PAA + SAX symbolization for Hopper (sm_90a).
//
// x [B, n] f32 (row-major, contiguous) -> paa [B, w] f32, sax [B, w] i32.
// PAA is the segment mean (sum of the n/w values of a segment, divided by
// n/w); the symbol is the number of breakpoints <= PAA, found by binary
// search over the c-1 breakpoints held in shared memory.
//
// One thread per (row, segment).  Neighbouring threads own neighbouring
// segments, so a warp reads one contiguous run of 32 segments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sax_encode_kernel(const float* __restrict__ x,
                                  const float* __restrict__ bp,
                                  float* __restrict__ paa,
                                  int32_t* __restrict__ sax,
                                  int B, int n, int w, int nbp) {
    extern __shared__ float s_bp[];
    for (int i = threadIdx.x; i < nbp; i += blockDim.x) s_bp[i] = bp[i];
    __syncthreads();

    const int seg = n / w;
    const float seg_len = (float)seg;
    const long long total = (long long)B * w;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += (long long)gridDim.x * blockDim.x) {
        const long long row = t / w;
        const int j = (int)(t - row * w);
        const float* p = x + row * n + (long long)j * seg;
        float s = 0.f;
        for (int i = 0; i < seg; ++i) s = __fadd_rn(s, p[i]);
        const float m = __fdiv_rn(s, seg_len);
        paa[t] = m;
        int lo = 0, hi = nbp;              // searchsorted(bp, m, side="right")
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_bp[mid] <= m) lo = mid + 1; else hi = mid;
        }
        sax[t] = lo;
    }
}

}  // namespace

extern "C" int dumpy_sax_encode_f32(const void* x, const void* bp, void* paa,
                                    void* sax, int B, int n, int w, int nbp,
                                    void* stream) {
    const int threads = 256;
    const long long total = (long long)B * w;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 4096) blocks = 4096;
    if (blocks < 1) blocks = 1;
    sax_encode_kernel<<<(unsigned)blocks, threads, nbp * sizeof(float),
                        (cudaStream_t)stream>>>(
        (const float*)x, (const float*)bp, (float*)paa, (int32_t*)sax,
        B, n, w, nbp);
    return (int)cudaGetLastError();
}
