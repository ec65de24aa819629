// gru_cell for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/gru_cell.py::_gru_cell_pallas (body
// _gru_kernel): out = GRU(x, h; W, U, b) over M rows, the memory cell of
// standard (Alg. 1) training, where the PRES filter is off and the memory
// update is the plain cell followed by the table scatter:
//   r = sigmoid(x W_r + b_r + h U_r),  z = sigmoid(x W_z + b_z + h U_z)
//   n = tanh(x W_n + b_n + r * (h U_n)),   h' = (1 - z) h + z n
// (no hidden bias, z weighting n: the JAX package's models/modules.py).
//
// The TPU kernel pads M to its 128-row tile and runs both products on the
// MXU with the weight panels whole in VMEM. Here the tile is gru_tile.cuh's
// (64 rows x 16 output columns a block, both products on the tensor cores
// at fp32 grade through tf32x3.cuh, the depth split over two halves of
// four warps, a three-stage cp.async ring), shared with memory_update.cu;
// this kernel's epilogue forms the gates and writes h'.
//
// Bound on this card: 2 * M * (Din + D) * 3D FLOPs plus the gate math
// (0.20 GFLOP at M = 2000, D = Din = 128) against 3.5 MB of rows and
// weights: a few microseconds on either unit; gru_tile.cuh says where the
// time goes instead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_tile.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(GT_THREADS) gru_cell_kernel(
        const float* __restrict__ x, int din,
        const float* __restrict__ h, int d,
        const float* __restrict__ w, const float* __restrict__ u,
        const float* __restrict__ b, int m, float* __restrict__ out) {
    extern __shared__ __align__(16) float ring[];   // GT_SMEM bytes
    gru_tile<VEC, false>(
        x, din, h, m, d, nullptr, w, u, m, ring,
        [&](int row, int j, const GruSums& s, float hv) {
            out[(int64_t)row * d + j] = gru_gates(s, b, d, j, hv);
        });
}

}  // namespace

extern "C" int repro_gru_cell(
        const void* x, int din, const void* h, int d, const void* w,
        const void* u, const void* b, int m, void* out, void* stream) {
    if (m <= 0) return 0;
    return gru_tile_launch(
        gru_cell_kernel<true>, gru_cell_kernel<false>, x, din, h, d, w, u, m,
        static_cast<cudaStream_t>(stream), static_cast<const float*>(x), din,
        static_cast<const float*>(h), d, static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(b), m,
        static_cast<float*>(out));
}
