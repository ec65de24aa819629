// memory_update_table and the dense memory_update for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/memory_update.py::_memory_update_table_pallas
// (body _memory_update_table_kernel). Per occurrence m of the touched rows:
//   h      = table[gidx[m]]            (gidx >= N reads zeros)
//   s_meas = GRU(x[m], h; W, U, b)      gates r, z, n over 3D columns
//   fused, delta = Eq. 7 -> 8 -> 9 of (h, s_meas, dmean[m]; scale[m], gamma)
//                  (pres_rows.cuh: predict, correct, delta rate)
//   table[widx[m]] = fused, last_t[widx[m]] = times[m]   for widx[m] < N
//
// And replaces src/repro/kernels/memory_update.py::_memory_update_pallas
// (body _memory_update_kernel), the dense form: the same rows kernel with
// h given in rows (no gather: gidx = nullptr, so row m reads h[m]), Din
// free, and no scatter; it returns (s_meas, fused, delta). The TPU kernel
// pads M to its 128-row tile; here the ragged last block masks itself.
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
// them over the block's GRU_ROWS occurrences, whose x and h rows sit in
// shared memory (a broadcast read per k); that GRU body is shared with
// gru_cell.cu (gru_rows.cuh). The filter runs on the column in registers,
// so s_meas never goes back to memory before it. fp32 FMA, no tensor cores
// yet.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_rows.cuh"
#include "pres_rows.cuh"

namespace {

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
    float* xs = smem;                      // GRU_ROWS x din
    float* hs = smem + GRU_ROWS * din;     // GRU_ROWS x d
    const int row0 = blockIdx.x * GRU_ROWS;
    const int nrows = min(GRU_ROWS, m - row0);
    gru_stage_rows(x, din, table, n_rows, d, gidx, row0, nrows, xs, hs);
    __syncthreads();

    const float gamma = *gamma_ptr;
    const float omg = __fsub_rn(1.0f, gamma);
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
        float sm[GRU_ROWS];
        gru_column(xs, hs, din, d, w, u, b, j, sm);
#pragma unroll
        for (int r = 0; r < GRU_ROWS; ++r) {
            if (r < nrows) {
                const int64_t o = (int64_t)(row0 + r) * d + j;
                float fu, de;
                pres_filter_elem(hs[r * d + j], sm[r], dmean[o],
                                 scale[row0 + r], gamma, omg, clip,
                                 innovation, fu, de);
                s_meas[o] = sm[r];
                fused[o] = fu;
                delta[o] = de;
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

// Phase 1 over m rows: h = table[gidx[r]] (gidx = nullptr: h = table[r]).
int launch_rows(const void* table, int64_t n_rows, int d, const void* x,
                int din, const void* gidx, const void* w, const void* u,
                const void* b, const void* dmean, const void* scale,
                const void* gamma, float clip, int innovation, int m,
                void* s_meas, void* fused, void* delta, cudaStream_t st) {
    const size_t smem = sizeof(float) * GRU_ROWS * (size_t)(din + d);
    cudaError_t e = gru_set_smem(memory_update_rows_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (m + GRU_ROWS - 1) / GRU_ROWS;
    memory_update_rows_kernel<<<blocks, GRU_THREADS, smem, st>>>(
        static_cast<const float*>(table), n_rows, d,
        static_cast<const float*>(x), din,
        static_cast<const int32_t*>(gidx),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(b), static_cast<const float*>(dmean),
        static_cast<const float*>(scale), static_cast<const float*>(gamma),
        clip, innovation, m, static_cast<float*>(s_meas),
        static_cast<float*>(fused), static_cast<float*>(delta));
    return (int)cudaGetLastError();
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
    int err = launch_rows(table, n_rows, d, x, din, gidx, w, u, b, dmean,
                          scale, gamma, clip, innovation, m, s_meas, fused,
                          delta, st);
    if (err != 0) return err;
    const int64_t total = (int64_t)m * d;
    const int threads = 256;
    const int sblocks = (int)((total + threads - 1) / threads);
    memory_update_scatter_kernel<<<sblocks, threads, 0, st>>>(
        static_cast<float*>(table), static_cast<float*>(last_t), n_rows, d,
        static_cast<const int32_t*>(widx), static_cast<const float*>(times),
        static_cast<const float*>(fused), m);
    return (int)cudaGetLastError();
}

extern "C" int repro_memory_update(
        const void* x, int din, const void* h, int d, const void* w,
        const void* u, const void* b, const void* dmean, const void* scale,
        const void* gamma, float clip, int innovation, int m, void* s_meas,
        void* fused, void* delta, void* stream) {
    if (m <= 0) return 0;
    return launch_rows(h, m, d, x, din, nullptr, w, u, b, dmean, scale,
                       gamma, clip, innovation, m, s_meas, fused, delta,
                       static_cast<cudaStream_t>(stream));
}
