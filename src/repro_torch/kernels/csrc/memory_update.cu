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
// 128) the gate products are 2 * M * (Din + D) * 3D FLOPs (0.40 GFLOP at
// M = 2048, D = Din = 128) against a few MB of rows: a few microseconds on
// the tensor cores at fp32 grade (three TF32 products a step). Phase 1 is
// gru_tile.cuh's GRU tile, written once for this file and gru_cell.cu: 64
// occurrences x 16 output columns a block, the depth split over two halves
// of four warps, the weight panels streamed through a three-stage cp.async
// ring, so each 64-row tile reads W and U (393 KB at D = Din = 128) once
// through L2. Its h rows are gathered through gidx by the
// copies themselves (zero-filled for a masked occurrence); its epilogue
// forms the gates in the plain version's order and runs the filter
// (pres_rows.cuh) on the registers, so s_meas never goes back to memory
// before it. M = 2048, D = 128 gives 32 x 8 = 256 blocks; CONFIG's
// M = 512, D = 100 gives 8 x 7 = 56.
//
// A bfloat16 table (JAX's mem_dtype="bfloat16"; the Pallas kernels cast
// each row to fp32 on load and write the table's dtype) takes three
// launches: the touched rows are gathered and widened to fp32 into a
// caller-given (M, D) scratch (exact: every bf16 value is an fp32 value),
// phase 1 runs on those rows in its dense form, and the scatter rounds
// each fused row to the nearest bf16, ties to even. last_t, the messages,
// s_meas, fused and delta stay fp32. The dense memory_update takes bf16 h
// rows the same way, widened into the scratch first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_tile.cuh"
#include "pres_rows.cuh"

namespace {

// Phase 1: VEC as in gru_tile.cuh; GATHER: h = table[gidx[r]], else h =
// table[r] (the dense form)
template <bool VEC, bool GATHER>
__global__ void __launch_bounds__(GT_THREADS) memory_update_rows_kernel(
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
    extern __shared__ __align__(16) float ring[];   // GT_SMEM bytes
    const float gamma = *gamma_ptr;
    const float omg = __fsub_rn(1.0f, gamma);
    gru_tile<VEC, GATHER>(
        x, din, table, n_rows, d, gidx, w, u, m, ring,
        [&](int row, int j, const GruSums& s, float hv) {
            const float sm = gru_gates(s, b, d, j, hv);
            const int64_t o = (int64_t)row * d + j;
            float fu, de;
            pres_filter_elem(hv, sm, dmean[o], scale[row], gamma, omg, clip,
                             innovation, fu, de);
            s_meas[o] = sm;
            fused[o] = fu;
            delta[o] = de;
        });
}

// Phase 2: a block a selected row (widx[r] < N): the fused row into the
// table, its time into last_t; the others return at once
__global__ void memory_update_scatter_kernel(
        float* __restrict__ table, float* __restrict__ last_t,
        int64_t n_rows, int d, const int32_t* __restrict__ widx,
        const float* __restrict__ times, const float* __restrict__ fused) {
    const int r = blockIdx.x;
    const int64_t wi = widx[r];
    if (wi < 0 || wi >= n_rows) return;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
        table[wi * d + c] = fused[(int64_t)r * d + c];
    if (threadIdx.x == 0) last_t[wi] = times[r];
}

// bf16 rows h[gidx[r]] (gidx = nullptr: h[r]) widened to fp32 into
// out (m, d); an index outside [0, n_rows) gives a row of zeros
__global__ void widen_bf16_rows_kernel(
        const __nv_bfloat16* __restrict__ h, int64_t n_rows, int d,
        const int32_t* __restrict__ gidx, float* __restrict__ out) {
    const int r = blockIdx.x;
    const int64_t g = gidx ? (int64_t)gidx[r] : r;
    const bool ok = g >= 0 && g < n_rows;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
        out[(int64_t)r * d + c] = ok ? __bfloat162float(h[g * d + c]) : 0.0f;
}

// Phase 2 on a bf16 table: the fused row rounded to nearest even
__global__ void memory_update_scatter_bf16_kernel(
        __nv_bfloat16* __restrict__ table, float* __restrict__ last_t,
        int64_t n_rows, int d, const int32_t* __restrict__ widx,
        const float* __restrict__ times, const float* __restrict__ fused) {
    const int r = blockIdx.x;
    const int64_t wi = widx[r];
    if (wi < 0 || wi >= n_rows) return;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
        table[wi * d + c] = __float2bfloat16_rn(fused[(int64_t)r * d + c]);
    if (threadIdx.x == 0) last_t[wi] = times[r];
}

// Phase 1 over m rows: h = table[gidx[r]] (gidx = nullptr: h = table[r]).
int launch_rows(const void* table, int64_t n_rows, int d, const void* x,
                int din, const void* gidx, const void* w, const void* u,
                const void* b, const void* dmean, const void* scale,
                const void* gamma, float clip, int innovation, int m,
                void* s_meas, void* fused, void* delta, cudaStream_t st) {
    const auto vec_kernel = gidx ? memory_update_rows_kernel<true, true>
                                 : memory_update_rows_kernel<true, false>;
    const auto plain_kernel = gidx ? memory_update_rows_kernel<false, true>
                                   : memory_update_rows_kernel<false, false>;
    return gru_tile_launch(
        vec_kernel, plain_kernel, x, din, table, d, w, u, m, st,
        static_cast<const float*>(table), n_rows, d,
        static_cast<const float*>(x), din,
        static_cast<const int32_t*>(gidx),
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(b), static_cast<const float*>(dmean),
        static_cast<const float*>(scale), static_cast<const float*>(gamma),
        clip, innovation, m, static_cast<float*>(s_meas),
        static_cast<float*>(fused), static_cast<float*>(delta));
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
    memory_update_scatter_kernel<<<m, 128, 0, st>>>(
        static_cast<float*>(table), static_cast<float*>(last_t), n_rows, d,
        static_cast<const int32_t*>(widx), static_cast<const float*>(times),
        static_cast<const float*>(fused));
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

extern "C" int repro_memory_update_table_bf16(
        void* table, void* last_t, int64_t n_rows, int d,
        const void* x, int din, const void* gidx, const void* widx,
        const void* times, const void* w, const void* u, const void* b,
        const void* dmean, const void* scale, const void* gamma, float clip,
        int innovation, int m, void* s_meas, void* fused, void* delta,
        void* h_scratch, void* stream) {
    if (m <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    widen_bf16_rows_kernel<<<m, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(table), n_rows, d,
        static_cast<const int32_t*>(gidx), static_cast<float*>(h_scratch));
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    err = launch_rows(h_scratch, m, d, x, din, nullptr, w, u, b, dmean, scale,
                      gamma, clip, innovation, m, s_meas, fused, delta, st);
    if (err != 0) return err;
    memory_update_scatter_bf16_kernel<<<m, 128, 0, st>>>(
        static_cast<__nv_bfloat16*>(table), static_cast<float*>(last_t),
        n_rows, d, static_cast<const int32_t*>(widx),
        static_cast<const float*>(times), static_cast<const float*>(fused));
    return (int)cudaGetLastError();
}

extern "C" int repro_memory_update_bf16(
        const void* x, int din, const void* h, int d, const void* w,
        const void* u, const void* b, const void* dmean, const void* scale,
        const void* gamma, float clip, int innovation, int m, void* s_meas,
        void* fused, void* delta, void* h_scratch, void* stream) {
    if (m <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    widen_bf16_rows_kernel<<<m, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h), m, d, nullptr,
        static_cast<float*>(h_scratch));
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    return launch_rows(h_scratch, m, d, x, din, nullptr, w, u, b, dmean,
                       scale, gamma, clip, innovation, m, s_meas, fused,
                       delta, st);
}
