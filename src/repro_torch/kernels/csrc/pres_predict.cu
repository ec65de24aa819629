// pres_predict for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/memory_update.py::_pres_predict_pallas (body
// _predict_kernel): the Eq. 7 staleness fill of the pipelined schedule,
//   out[i, j] = s[i, j] + clip(scale[i] * dmean[i, j], -clip, clip)
// over the whole (N, D) memory snapshot, scale[i] being node i's count of
// writes not yet in the snapshot (0 leaves the row as it was).
//
// The TPU kernel pads M to its 256-row tile and walks the tiles in order.
// Here a grid-stride loop covers the M * D elements, four at a time with
// 16-byte loads and stores where D % 4 == 0 (the four then share one row,
// so one scale load serves them), one at a time otherwise; the ragged end
// needs no padding copy.
//
// Bound on this card: three fp32 (M, D) arrays move once each (two read,
// one written) and each element costs four operations, so HBM bandwidth
// bounds it: at M = 120,000, D = 128 about 185 MB, 0.055 ms at 3.35 TB/s.
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn,
// with the clamp between them), the roundings of the plain version, so
// the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PP_THREADS = 256;
constexpr int PP_MAX_BLOCKS = 132 * 16;   // 16 blocks per SM of the H100

__device__ __forceinline__ float fill(float s, float dm, float sc,
                                      float clip) {
    const float p = fminf(fmaxf(__fmul_rn(sc, dm), -clip), clip);
    return __fadd_rn(s, p);
}

__global__ void __launch_bounds__(PP_THREADS) pres_predict_vec4_kernel(
        const float4* __restrict__ s, const float4* __restrict__ dm,
        const float* __restrict__ scale, int64_t n4, int d4, float clip,
        float4* __restrict__ out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
         i += (int64_t)gridDim.x * blockDim.x) {
        const float sc = __ldg(scale + i / d4);
        const float4 a = __ldg(s + i);
        const float4 b = __ldg(dm + i);
        out[i] = make_float4(fill(a.x, b.x, sc, clip), fill(a.y, b.y, sc, clip),
                             fill(a.z, b.z, sc, clip), fill(a.w, b.w, sc, clip));
    }
}

__global__ void __launch_bounds__(PP_THREADS) pres_predict_kernel(
        const float* __restrict__ s, const float* __restrict__ dm,
        const float* __restrict__ scale, int64_t n, int d, float clip,
        float* __restrict__ out) {
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        out[i] = fill(__ldg(s + i), __ldg(dm + i), __ldg(scale + i / d), clip);
    }
}

int grid_for(int64_t items) {
    const int64_t blocks = (items + PP_THREADS - 1) / PP_THREADS;
    return (int)(blocks < PP_MAX_BLOCKS ? blocks : PP_MAX_BLOCKS);
}

}  // namespace

extern "C" int repro_pres_predict(
        const void* s, const void* dmean, const void* scale, int64_t m, int d,
        float clip, void* out, void* stream) {
    if (m <= 0 || d <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t n = m * (int64_t)d;
    const bool aligned =
        d % 4 == 0 && ((uintptr_t)s | (uintptr_t)dmean | (uintptr_t)out) % 16 == 0;
    if (aligned) {
        pres_predict_vec4_kernel<<<grid_for(n / 4), PP_THREADS, 0, st>>>(
            static_cast<const float4*>(s), static_cast<const float4*>(dmean),
            static_cast<const float*>(scale), n / 4, d / 4, clip,
            static_cast<float4*>(out));
    } else {
        pres_predict_kernel<<<grid_for(n), PP_THREADS, 0, st>>>(
            static_cast<const float*>(s), static_cast<const float*>(dmean),
            static_cast<const float*>(scale), n, d, clip,
            static_cast<float*>(out));
    }
    return (int)cudaGetLastError();
}
