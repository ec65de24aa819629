// GRU row-block body shared by memory_update.cu (phase 1) and gru_cell.cu.
//
// A block owns GRU_ROWS consecutive rows. Their x rows (Din wide) and
// previous-state rows h (D wide) are staged in shared memory; each thread
// then owns output columns j (strided by blockDim.x) and accumulates the
// six gate products of its column for all GRU_ROWS rows at once, reading
// W[k, j], W[k, D + j], W[k, 2D + j] (and the same of U) once per k through
// L2 (__ldg) and reusing them over the rows held in shared memory.
//
// The cell is the JAX package's (models/modules.py::gru_cell):
//   r = sigmoid(x W_r + b_r + h U_r),  z = sigmoid(x W_z + b_z + h U_z)
//   n = tanh(x W_n + b_n + r * (h U_n)),   h' = (1 - z) h + z n
// with no hidden bias and z weighting n (PyTorch's GRUCell weights h by z).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GRU_ROWS = 8;        // rows per block
constexpr int GRU_THREADS = 128;   // threads per block, strided over columns

__device__ __forceinline__ float gru_sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// Stage rows [row0, row0 + nrows) of x into xs (GRU_ROWS x din) and their
// previous states into hs (GRU_ROWS x d). Row r's state is h[hidx[row0 + r]]
// when hidx is given (a gather; any index outside [0, n_h) reads zeros),
// else h[row0 + r]. Rows past nrows are zero-filled.
__device__ __forceinline__ void gru_stage_rows(
        const float* __restrict__ x, int din,
        const float* __restrict__ h, int64_t n_h, int d,
        const int32_t* __restrict__ hidx, int row0, int nrows,
        float* __restrict__ xs, float* __restrict__ hs) {
    for (int i = threadIdx.x; i < GRU_ROWS * din; i += blockDim.x) {
        const int r = i / din;
        const int c = i - r * din;
        xs[i] = (r < nrows) ? x[(int64_t)(row0 + r) * din + c] : 0.0f;
    }
    for (int i = threadIdx.x; i < GRU_ROWS * d; i += blockDim.x) {
        const int r = i / d;
        const int c = i - r * d;
        float v = 0.0f;
        if (r < nrows) {
            const int64_t g = hidx ? (int64_t)hidx[row0 + r]
                                   : (int64_t)(row0 + r);
            if (g >= 0 && g < n_h) v = h[g * d + c];
        }
        hs[i] = v;
    }
}

// New state of column j for every staged row: out[r] = h'[r, j].
__device__ __forceinline__ void gru_column(
        const float* __restrict__ xs, const float* __restrict__ hs,
        int din, int d, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ b, int j,
        float (&out)[GRU_ROWS]) {
    float xr[GRU_ROWS], xz[GRU_ROWS], xn[GRU_ROWS];
    float hr[GRU_ROWS], hz[GRU_ROWS], hn[GRU_ROWS];
#pragma unroll
    for (int r = 0; r < GRU_ROWS; ++r) {
        xr[r] = xz[r] = xn[r] = 0.0f;
        hr[r] = hz[r] = hn[r] = 0.0f;
    }
    const int64_t d3 = 3 * (int64_t)d;
    for (int k = 0; k < din; ++k) {
        const float* wk = w + k * d3;
        const float w0 = __ldg(wk + j);
        const float w1 = __ldg(wk + d + j);
        const float w2 = __ldg(wk + 2 * d + j);
#pragma unroll
        for (int r = 0; r < GRU_ROWS; ++r) {
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
        for (int r = 0; r < GRU_ROWS; ++r) {
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
    for (int r = 0; r < GRU_ROWS; ++r) {
        const float h = hs[r * d + j];
        const float rg = gru_sigmoid((xr[r] + b0) + hr[r]);
        const float zg = gru_sigmoid((xz[r] + b1) + hz[r]);
        const float ng = tanhf((xn[r] + b2) + rg * hn[r]);
        out[r] = (1.0f - zg) * h + zg * ng;
    }
}

// Dynamic shared memory of one block, opting in above the 48 KB default.
template <typename Kernel>
cudaError_t gru_set_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
