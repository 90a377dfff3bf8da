// Squared-L2 distance matrix for Hopper (sm_90a), full float32.
//
// q [Q, n], x [X, n] f32 (row-major, contiguous) -> out [Q, X] f32 with
//     out[i, j] = max((|q_i|^2 + |x_j|^2) - 2 q_i.x_j, 0).
//
// A shared-memory tiled product: each block owns a TQ x TX output tile and
// walks the contraction in TK-wide steps; each of its 128 threads keeps a
// 4 x 4 register tile of float32 FMA sums.  The row norms are summed from
// the same shared-memory tiles in the same pass (threads 0..TQ-1 for the
// query rows, TQ..TQ+TX-1 for the candidate rows) and applied in the
// epilogue.  No tensor cores: TF32 keeps ~10 mantissa bits, which would move
// d^2 by ~0.5 at |x|^2 ~ 256 and reorder true neighbours.  Rows past Q / X
// and columns past n are masked at load and store; nothing is padded in
// device memory.
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;
constexpr int TX = 64;
constexpr int TK = 16;
constexpr int THREADS = 128;   // 8 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
pairwise_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                   float* __restrict__ out, int Q, int X, int n) {
    __shared__ float As[TK][TQ + 1];   // +1: conflict-free transposed stores
    __shared__ float Bs[TK][TX + 1];
    __shared__ float qn_s[TQ];
    __shared__ float xn_s[TX];

    const int tid = threadIdx.x;
    const int ty = tid / 16;           // 0..7  -> query rows ty*4 .. ty*4+3
    const int tx = tid % 16;           // 0..15 -> cand rows tx*4 .. tx*4+3
    const int q0 = blockIdx.y * TQ;
    const int x0 = blockIdx.x * TX;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float norm = 0.f;

    for (int k0 = 0; k0 < n; k0 += TK) {
#pragma unroll
        for (int i = 0; i < (TQ * TK) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / TK, c = idx % TK;
            const int gr = q0 + r, gc = k0 + c;
            As[c][r] = (gr < Q && gc < n) ? q[(size_t)gr * n + gc] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < (TX * TK) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / TK, c = idx % TK;
            const int gr = x0 + r, gc = k0 + c;
            Bs[c][r] = (gr < X && gc < n) ? x[(size_t)gr * n + gc] : 0.f;
        }
        __syncthreads();

        if (tid < TQ) {
#pragma unroll
            for (int c = 0; c < TK; ++c) norm = fmaf(As[c][tid], As[c][tid], norm);
        } else if (tid < TQ + TX) {
            const int r = tid - TQ;
#pragma unroll
            for (int c = 0; c < TK; ++c) norm = fmaf(Bs[c][r], Bs[c][r], norm);
        }

#pragma unroll
        for (int c = 0; c < TK; ++c) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[c][ty * 4 + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[c][tx * 4 + j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    if (tid < TQ) qn_s[tid] = norm;
    else if (tid < TQ + TX) xn_s[tid - TQ] = norm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = x0 + tx * 4 + j;
            if (c >= X) continue;
            const float v = __fsub_rn(__fadd_rn(qn_s[ty * 4 + i], xn_s[tx * 4 + j]),
                                      __fmul_rn(2.f, acc[i][j]));
            out[(size_t)r * X + c] = fmaxf(v, 0.f);
        }
    }
}

}  // namespace

extern "C" int dumpy_pairwise_l2_f32(const void* q, const void* x, void* out,
                                     int Q, int X, int n, void* stream) {
    dim3 grid((X + TX - 1) / TX, (Q + TQ - 1) / TQ);
    pairwise_l2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)x, (float*)out, Q, X, n);
    return (int)cudaGetLastError();
}
