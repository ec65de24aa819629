// pres_filter for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/pres_filter.py::_pres_filter_pallas (body
// _filter_kernel): the PRES filter of the unfused memory route (every PRES
// configuration whose memory cell is not the fused GRU), over the M
// touched occurrence rows:
//   fused, delta = Eq. 7 -> Eq. 8 -> Eq. 9 of (s_prev, s_meas, dmean;
//                  dt[i], gamma)                      (pres_rows.cuh)
//
// The TPU kernel pads M to its 256-row tile (dt padded with 1) and walks
// the tiles in order. Here a grid-stride loop covers the M * D elements,
// four at a time with 16-byte loads and stores where D % 4 == 0 and every
// row pointer is 16-byte aligned (the four then share one row, so one dt
// load serves them), one at a time otherwise; the ragged end needs no
// padding.
//
// Bound on this card: five fp32 (M, D) arrays move once each (three read,
// two written) plus dt, 20 M D + 4 M bytes, against about ten operations
// an element, so HBM bandwidth bounds it: 1.5 us at M = 2,000, D = 128 at
// 3.35 TB/s. At the training shapes the launch costs more than that.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pres_rows.cuh"

namespace {

constexpr int PF_THREADS = 256;
constexpr int PF_MAX_BLOCKS = 132 * 16;   // 16 blocks per SM of the H100

__global__ void __launch_bounds__(PF_THREADS) pres_filter_vec4_kernel(
        const float4* __restrict__ s, const float4* __restrict__ sm,
        const float4* __restrict__ dm, const float* __restrict__ dt,
        const float* __restrict__ gamma_ptr, int64_t n4, int d4, float clip,
        int innovation, float4* __restrict__ fused,
        float4* __restrict__ delta) {
    const float g = __ldg(gamma_ptr);
    const float omg = __fsub_rn(1.0f, g);
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
         i += (int64_t)gridDim.x * blockDim.x) {
        const float sc = __ldg(dt + i / d4);
        const float4 a = __ldg(s + i);
        const float4 b = __ldg(sm + i);
        const float4 c = __ldg(dm + i);
        float4 f, e;
        pres_filter_elem(a.x, b.x, c.x, sc, g, omg, clip, innovation, f.x, e.x);
        pres_filter_elem(a.y, b.y, c.y, sc, g, omg, clip, innovation, f.y, e.y);
        pres_filter_elem(a.z, b.z, c.z, sc, g, omg, clip, innovation, f.z, e.z);
        pres_filter_elem(a.w, b.w, c.w, sc, g, omg, clip, innovation, f.w, e.w);
        fused[i] = f;
        delta[i] = e;
    }
}

__global__ void __launch_bounds__(PF_THREADS) pres_filter_kernel(
        const float* __restrict__ s, const float* __restrict__ sm,
        const float* __restrict__ dm, const float* __restrict__ dt,
        const float* __restrict__ gamma_ptr, int64_t n, int d, float clip,
        int innovation, float* __restrict__ fused,
        float* __restrict__ delta) {
    const float g = __ldg(gamma_ptr);
    const float omg = __fsub_rn(1.0f, g);
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        pres_filter_elem(__ldg(s + i), __ldg(sm + i), __ldg(dm + i),
                         __ldg(dt + i / d), g, omg, clip, innovation,
                         fused[i], delta[i]);
    }
}

int grid_for(int64_t items) {
    const int64_t blocks = (items + PF_THREADS - 1) / PF_THREADS;
    return (int)(blocks < PF_MAX_BLOCKS ? blocks : PF_MAX_BLOCKS);
}

}  // namespace

extern "C" int repro_pres_filter(
        const void* s_prev, const void* s_meas, const void* dmean,
        const void* dt, const void* gamma, int64_t m, int d, float clip,
        int innovation, void* fused, void* delta, void* stream) {
    if (m <= 0 || d <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t n = m * (int64_t)d;
    const uintptr_t ptrs = (uintptr_t)s_prev | (uintptr_t)s_meas |
                           (uintptr_t)dmean | (uintptr_t)fused |
                           (uintptr_t)delta;
    if (d % 4 == 0 && ptrs % 16 == 0) {
        pres_filter_vec4_kernel<<<grid_for(n / 4), PF_THREADS, 0, st>>>(
            static_cast<const float4*>(s_prev),
            static_cast<const float4*>(s_meas),
            static_cast<const float4*>(dmean), static_cast<const float*>(dt),
            static_cast<const float*>(gamma), n / 4, d / 4, clip, innovation,
            static_cast<float4*>(fused), static_cast<float4*>(delta));
    } else {
        pres_filter_kernel<<<grid_for(n), PF_THREADS, 0, st>>>(
            static_cast<const float*>(s_prev),
            static_cast<const float*>(s_meas),
            static_cast<const float*>(dmean), static_cast<const float*>(dt),
            static_cast<const float*>(gamma), n, d, clip, innovation,
            static_cast<float*>(fused), static_cast<float*>(delta));
    }
    return (int)cudaGetLastError();
}
