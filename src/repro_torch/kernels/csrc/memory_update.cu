// memory_update_table for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/memory_update.py::_memory_update_table_pallas
// (body _memory_update_table_kernel). Per occurrence m of the touched rows:
//   h      = table[gidx[m]]            (gidx >= N reads zeros)
//   s_meas = GRU(x[m], h; W, U, b)      gates r, z, n over 3D columns
//   s_pred = h + clip(scale[m] * dmean[m], +-clip)             (Eq. 7)
//   fused  = (1 - gamma) s_pred + gamma s_meas                 (Eq. 8)
//   delta  = (fused - base) / max(scale[m], 1), base = s_pred (innovation)
//            or h (transition)                                 (Eq. 9)
//   table[widx[m]] = fused, last_t[widx[m]] = times[m]   for widx[m] < N
//
// The TPU kernel walks the occurrences in order through an aliased table,
// which is hazard-free only because its grid is sequential. Blocks here run
// concurrently and one node's occurrences can straddle two blocks, so the
// pass is split in two launches: phase 1 reads only the old table and
// writes the (M, D) s_meas / fused / delta; phase 2 scatters the selected
// rows (one per node, so the writes are unique) into the (N, D) table in
// place. Row N (dump) and N + 1 (zeros) are handled by index tests, never
// materialised.
//
// Bound on this card: at the serving shapes (M = 32..2048, D = Din = 100 or
// 128) the gate products are 2 * M * (Din + D) * 3D FLOPs (0.25 GFLOP at
// M = 2048, D = Din = 100) against a few MB of rows, so the fp32 FMA rate
// bounds it. W + U (240 KB at D = 100) exceed one block's shared memory, so
// the weights are read through L2 with __ldg: each thread owns one output
// column j, loads W[k, j], W[k, D + j], W[k, 2D + j] once per k and reuses
// them over the block's MU_ROWS occurrences, whose x and h rows sit in
// shared memory (a broadcast read per k). fp32 FMA, no tensor cores yet.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MU_ROWS = 8;        // occurrences per block
constexpr int MU_THREADS = 128;   // threads per block, strided over D columns

__device__ __forceinline__ float sigmoid_f(float x) {
    return 1.0f / (1.0f + expf(-x));
}

__global__ void memory_update_rows_kernel(
        const float* __restrict__ table, int64_t n_rows, int d,
        const float* __restrict__ x, int din,
        const int32_t* __restrict__ gidx,
        const float* __restrict__ w, const float* __restrict__ u,
        const float* __restrict__ b,
        const float* __restrict__ dmean, const float* __restrict__ scale,
        const float* __restrict__ gamma_ptr, float clip, int innovation,
        int m,
        float* __restrict__ s_meas, float* __restrict__ fused,
        float* __restrict__ delta) {
    extern __shared__ float smem[];
    float* xs = smem;                     // MU_ROWS x din
    float* hs = smem + MU_ROWS * din;     // MU_ROWS x d
    const int row0 = blockIdx.x * MU_ROWS;
    const int nrows = min(MU_ROWS, m - row0);

    for (int i = threadIdx.x; i < MU_ROWS * din; i += blockDim.x) {
        const int r = i / din;
        const int c = i - r * din;
        xs[i] = (r < nrows) ? x[(int64_t)(row0 + r) * din + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < MU_ROWS * d; i += blockDim.x) {
        const int r = i / d;
        const int c = i - r * d;
        float v = 0.0f;
        if (r < nrows) {
            const int64_t g = gidx[row0 + r];
            if (g >= 0 && g < n_rows) v = table[g * d + c];
        }
        hs[i] = v;
    }
    __syncthreads();

    const float gamma = *gamma_ptr;
    const int64_t d3 = 3 * (int64_t)d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
        float xr[MU_ROWS], xz[MU_ROWS], xn[MU_ROWS];
        float hr[MU_ROWS], hz[MU_ROWS], hn[MU_ROWS];
#pragma unroll
        for (int r = 0; r < MU_ROWS; ++r) {
            xr[r] = xz[r] = xn[r] = 0.0f;
            hr[r] = hz[r] = hn[r] = 0.0f;
        }
        for (int k = 0; k < din; ++k) {
            const float* wk = w + k * d3;
            const float w0 = __ldg(wk + j);
            const float w1 = __ldg(wk + d + j);
            const float w2 = __ldg(wk + 2 * d + j);
#pragma unroll
            for (int r = 0; r < MU_ROWS; ++r) {
                const float xv = xs[r * din + k];
                xr[r] = fmaf(xv, w0, xr[r]);
                xz[r] = fmaf(xv, w1, xz[r]);
                xn[r] = fmaf(xv, w2, xn[r]);
            }
        }
        for (int k = 0; k < d; ++k) {
            const float* uk = u + k * d3;
            const float u0 = __ldg(uk + j);
            const float u1 = __ldg(uk + d + j);
            const float u2 = __ldg(uk + 2 * d + j);
#pragma unroll
            for (int r = 0; r < MU_ROWS; ++r) {
                const float hv = hs[r * d + k];
                hr[r] = fmaf(hv, u0, hr[r]);
                hz[r] = fmaf(hv, u1, hz[r]);
                hn[r] = fmaf(hv, u2, hn[r]);
            }
        }
        const float b0 = b[j];
        const float b1 = b[d + j];
        const float b2 = b[2 * d + j];
#pragma unroll
        for (int r = 0; r < MU_ROWS; ++r) {
            if (r < nrows) {
                const float h = hs[r * d + j];
                const float rg = sigmoid_f((xr[r] + b0) + hr[r]);
                const float zg = sigmoid_f((xz[r] + b1) + hz[r]);
                const float ng = tanhf((xn[r] + b2) + rg * hn[r]);
                const float sm = (1.0f - zg) * h + zg * ng;
                const int64_t o = (int64_t)(row0 + r) * d + j;
                const float sc = scale[row0 + r];
                const float step = fminf(fmaxf(sc * dmean[o], -clip), clip);
                const float sp = h + step;
                const float fu = (1.0f - gamma) * sp + gamma * sm;
                const float base = innovation ? sp : h;
                s_meas[o] = sm;
                fused[o] = fu;
                delta[o] = (fu - base) / fmaxf(sc, 1.0f);
            }
        }
    }
}

__global__ void memory_update_scatter_kernel(
        float* __restrict__ table, float* __restrict__ last_t,
        int64_t n_rows, int d, const int32_t* __restrict__ widx,
        const float* __restrict__ times, const float* __restrict__ fused,
        int m) {
    const int64_t total = (int64_t)m * d;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (int64_t)gridDim.x * blockDim.x) {
        const int r = (int)(i / d);
        const int c = (int)(i - (int64_t)r * d);
        const int64_t wi = widx[r];
        if (wi >= 0 && wi < n_rows) {
            table[wi * d + c] = fused[i];
            if (c == 0) last_t[wi] = times[r];
        }
    }
}

}  // namespace

extern "C" int repro_memory_update_table(
        void* table, void* last_t, int64_t n_rows, int d,
        const void* x, int din, const void* gidx, const void* widx,
        const void* times, const void* w, const void* u, const void* b,
        const void* dmean, const void* scale, const void* gamma, float clip,
        int innovation, int m, void* s_meas, void* fused, void* delta,
        void* stream) {
    if (m <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = sizeof(float) * MU_ROWS * (size_t)(din + d);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            memory_update_rows_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (m + MU_ROWS - 1) / MU_ROWS;
    memory_update_rows_kernel<<<blocks, MU_THREADS, smem, st>>>(
        static_cast<const float*>(table), n_rows, d,
        static_cast<const float*>(x), din,
        static_cast<const int32_t*>(gidx),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(b), static_cast<const float*>(dmean),
        static_cast<const float*>(scale), static_cast<const float*>(gamma),
        clip, innovation, m, static_cast<float*>(s_meas),
        static_cast<float*>(fused), static_cast<float*>(delta));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t total = (int64_t)m * d;
    const int threads = 256;
    const int sblocks = (int)((total + threads - 1) / threads);
    memory_update_scatter_kernel<<<sblocks, threads, 0, st>>>(
        static_cast<float*>(table), static_cast<float*>(last_t), n_rows, d,
        static_cast<const int32_t*>(widx), static_cast<const float*>(times),
        static_cast<const float*>(fused), m);
    return (int)cudaGetLastError();
}
