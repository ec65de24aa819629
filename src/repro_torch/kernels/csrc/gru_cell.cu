// gru_cell for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/gru_cell.py::_gru_cell_pallas (body
// _gru_kernel): out = GRU(x, h; W, U, b) over M rows, the memory cell of
// standard (Alg. 1) training, where the PRES filter is off and the memory
// update is the plain cell followed by the table scatter.
//
// The TPU kernel pads M to its 128-row tile and runs both products on the
// MXU with the weight panels whole in VMEM. Here a block owns GRU_ROWS rows
// and masks the ragged last block itself (no padding copies, M = 1 is one
// block). W + U (240 KB at D = Din = 100) exceed a block's shared memory, so
// each thread owns one output column and reads its weights through L2 with
// __ldg, reusing each over the block's rows staged in shared memory
// (gru_rows.cuh, the same body as memory_update.cu's phase 1).
//
// Bound on this card: 2 * M * (Din + D) * 3D FLOPs plus the gate math
// (0.12 GFLOP at M = 1000, D = Din = 100) against about 1.3 MB of rows and
// weights, so the fp32 FMA rate bounds it (about 2 us at 67 TFLOP/s). At
// these sizes 125-250 blocks of 128 threads cannot fill the card's 132 SMs
// for long: the launch and the serial K loop set the time, not the bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_rows.cuh"

namespace {

__global__ void gru_cell_kernel(
        const float* __restrict__ x, int din,
        const float* __restrict__ h, int d,
        const float* __restrict__ w, const float* __restrict__ u,
        const float* __restrict__ b, int m, float* __restrict__ out) {
    extern __shared__ float smem[];
    float* xs = smem;                      // GRU_ROWS x din
    float* hs = smem + GRU_ROWS * din;     // GRU_ROWS x d
    const int row0 = blockIdx.x * GRU_ROWS;
    const int nrows = min(GRU_ROWS, m - row0);
    gru_stage_rows(x, din, h, m, d, nullptr, row0, nrows, xs, hs);
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
        float hn[GRU_ROWS];
        gru_column(xs, hs, din, d, w, u, b, j, hn);
#pragma unroll
        for (int r = 0; r < GRU_ROWS; ++r) {
            if (r < nrows) out[(int64_t)(row0 + r) * d + j] = hn[r];
        }
    }
}

}  // namespace

extern "C" int repro_gru_cell(
        const void* x, int din, const void* h, int d, const void* w,
        const void* u, const void* b, int m, void* out, void* stream) {
    if (m <= 0) return 0;
    const size_t smem = sizeof(float) * GRU_ROWS * (size_t)(din + d);
    cudaError_t e = gru_set_smem(gru_cell_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (m + GRU_ROWS - 1) / GRU_ROWS;
    gru_cell_kernel<<<blocks, GRU_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), din, static_cast<const float*>(h), d,
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(b), m, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
