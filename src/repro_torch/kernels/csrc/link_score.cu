// link_score for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/link_score.py::_link_score_pallas (body
// _link_score_kernel). scores[b, i] = relu(hs[b] @ W1[:D] + hi[i] @ W1[D:]
// + b1) . w2 + b2 for every (source, item) pair, without the (B, I, D)
// hidden tensor ever reaching device memory.
//
// Two hand-written steps in one call. (1) link_factor_kernel computes the
// rank-D factors A = hs @ W1[:D] (B, D) and C = hi @ W1[D:] (I, D), one
// thread per output column reusing each weight over LF_ROWS rows held in
// shared memory. (2) link_pair_kernel tiles the pair grid LP_B x LP_I:
// the tile's A and C rows sit in shared memory (row stride D + 1, so the
// 32 item rows a warp reads fall in distinct banks), and each thread forms
// the hidden values of its LP_B / LP_ROWS_PER_THREAD pairs in registers,
// one d at a time, writing only the score.
//
// Bound on this card: the pair pass does 3 * B * I * D operations (add,
// relu, FMA) on (B + I) * D inputs and B * I outputs; at B = 1024, I =
// 20000, D = 128 that is 7.9 GFLOP against 82 MB, so the fp32 rate bounds
// it; at B = 16 the score write and the factor reads bound it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LF_ROWS = 8;
constexpr int LF_THREADS = 128;
constexpr int LP_B = 16;       // source rows per pair tile
constexpr int LP_I = 64;       // item rows per pair tile
constexpr int LP_THREADS = 256;
constexpr int LP_ROWS_PER_THREAD = LP_B * LP_I / LP_THREADS;   // 4

// out[r, :] = x[r, :] @ w  with x (rows, d) and w (d, d) row-major.
__global__ void link_factor_kernel(const float* __restrict__ x, int rows,
                                   const float* __restrict__ w, int d,
                                   float* __restrict__ out) {
    extern __shared__ float xs[];      // LF_ROWS x d
    const int row0 = blockIdx.x * LF_ROWS;
    const int nrows = min(LF_ROWS, rows - row0);
    for (int i = threadIdx.x; i < LF_ROWS * d; i += blockDim.x) {
        const int r = i / d;
        xs[i] = (r < nrows) ? x[(int64_t)(row0 + r) * d + (i - r * d)] : 0.0f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
        float acc[LF_ROWS];
#pragma unroll
        for (int r = 0; r < LF_ROWS; ++r) acc[r] = 0.0f;
        for (int k = 0; k < d; ++k) {
            const float wv = __ldg(w + (int64_t)k * d + j);
#pragma unroll
            for (int r = 0; r < LF_ROWS; ++r)
                acc[r] = fmaf(xs[r * d + k], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < LF_ROWS; ++r)
            if (r < nrows) out[(int64_t)(row0 + r) * d + j] = acc[r];
    }
}

__global__ void link_pair_kernel(const float* __restrict__ a, int nb,
                                 const float* __restrict__ c, int ni, int d,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 float* __restrict__ out) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    float* as = smem;                  // LP_B x ld
    float* cs = as + LP_B * ld;        // LP_I x ld
    float* bs = cs + LP_I * ld;        // d
    float* ws = bs + d;                // d
    const int b0 = blockIdx.y * LP_B;
    const int i0 = blockIdx.x * LP_I;
    for (int t = threadIdx.x; t < LP_B * d; t += blockDim.x) {
        const int r = t / d;
        const int k = t - r * d;
        as[r * ld + k] = (b0 + r < nb) ? a[(int64_t)(b0 + r) * d + k] : 0.0f;
    }
    for (int t = threadIdx.x; t < LP_I * d; t += blockDim.x) {
        const int r = t / d;
        const int k = t - r * d;
        cs[r * ld + k] = (i0 + r < ni) ? c[(int64_t)(i0 + r) * d + k] : 0.0f;
    }
    for (int k = threadIdx.x; k < d; k += blockDim.x) {
        bs[k] = b1[k];
        ws[k] = w2[k];
    }
    __syncthreads();
    const int ti = threadIdx.x % LP_I;
    const int tb = (threadIdx.x / LP_I) * LP_ROWS_PER_THREAD;
    float acc[LP_ROWS_PER_THREAD];
#pragma unroll
    for (int q = 0; q < LP_ROWS_PER_THREAD; ++q) acc[q] = 0.0f;
    const float* crow = cs + ti * ld;
    for (int k = 0; k < d; ++k) {
        const float cv = crow[k];
        const float bv = bs[k];
        const float wv = ws[k];
#pragma unroll
        for (int q = 0; q < LP_ROWS_PER_THREAD; ++q) {
            const float hv = fmaxf((as[(tb + q) * ld + k] + cv) + bv, 0.0f);
            acc[q] = fmaf(hv, wv, acc[q]);
        }
    }
    const float bias = b2[0];
    if (i0 + ti < ni) {
#pragma unroll
        for (int q = 0; q < LP_ROWS_PER_THREAD; ++q) {
            const int bb = b0 + tb + q;
            if (bb < nb) out[(int64_t)bb * ni + i0 + ti] = acc[q] + bias;
        }
    }
}

int launch_factor(const float* x, int rows, const float* w, int d, float* out,
                  cudaStream_t st) {
    if (rows <= 0) return 0;
    const size_t smem = sizeof(float) * LF_ROWS * (size_t)d;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            link_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    link_factor_kernel<<<(rows + LF_ROWS - 1) / LF_ROWS, LF_THREADS, smem,
                         st>>>(x, rows, w, d, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_link_score(const void* h_src, const void* h_items,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, int nb,
                                int ni, int d, void* a_scratch,
                                void* c_scratch, void* out, void* stream) {
    if (nb <= 0 || ni <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* w1f = static_cast<const float*>(w1);
    int err = launch_factor(static_cast<const float*>(h_src), nb, w1f, d,
                            static_cast<float*>(a_scratch), st);
    if (err) return err;
    err = launch_factor(static_cast<const float*>(h_items), ni,
                        w1f + (int64_t)d * d, d,
                        static_cast<float*>(c_scratch), st);
    if (err) return err;
    const size_t smem = sizeof(float) *
        ((size_t)(LP_B + LP_I) * (d + 1) + 2 * (size_t)d);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            link_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((ni + LP_I - 1) / LP_I, (nb + LP_B - 1) / LP_B);
    link_pair_kernel<<<grid, LP_THREADS, smem, st>>>(
        static_cast<const float*>(a_scratch), nb,
        static_cast<const float*>(c_scratch), ni, d,
        static_cast<const float*>(b1), static_cast<const float*>(w2),
        static_cast<const float*>(b2), static_cast<float*>(out));
    return (int)cudaGetLastError();
}
