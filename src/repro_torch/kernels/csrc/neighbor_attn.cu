// neighbor_attn for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/neighbor_attn.py::_neighbor_attn_pallas (body
// _attn_kernel): single-head masked attention of each row over its K
// slots, the heads already folded into the rows by the caller:
//   s_j   = q . k_j / sqrt(E)            (E = the folded row's width)
//   p     = softmax over the valid slots (invalid slots weigh 0)
//   out   = sum_j p_j v_j, and exactly 0 for a row with no valid slot
// for q (M, E), k and v (M, K, E), valid (M, K) as bytes (0 or 1).
//
// The TPU kernel holds 128 rows with their (K, E) keys and values in one
// VMEM tile and walks the tiles in order. Here one warp owns one row: lane
// l holds q[l], q[l + 32], ... in registers; for each slot the warp reads
// k_j as coalesced 128-byte segments, sums the lanes' partial products
// with shuffles, and lane (j % 32) keeps the score of slot j, so the max,
// the exponentials and their sum are warp reductions over registers; then
// the warp reads each v_j once and accumulates p_j v_j in the lanes' own
// registers and writes the row once. Nothing crosses warps.
//
// Bound on this card: every key and value is read once and used for 2
// FLOPs, so HBM bandwidth bounds it (the dense TGN layer 1 at production
// widths reads about 0.5 GB each of k and v: about 0.3 ms at 3.35 TB/s).
// The score is divided by sqrt(E), as the plain version divides; exp is
// expf, not __expf (the build never uses --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NA_WARPS = 8;              // rows per block
constexpr int NA_MAX_K = 128;            // slots: NA_MAX_K / 32 scores a lane
constexpr int NA_KPL = NA_MAX_K / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

// EPL: values of a row each lane holds (E <= 32 * EPL)
template <int EPL>
__global__ void __launch_bounds__(NA_WARPS * 32) neighbor_attn_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const uint8_t* __restrict__ valid,
        int m, int kk, int e, float div, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int64_t row = (int64_t)blockIdx.x * NA_WARPS + (threadIdx.x >> 5);
    if (row >= m) return;                      // whole warps leave together
    float qr[EPL];
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
        const int j = u * 32 + lane;
        qr[u] = j < e ? __ldg(q + row * e + j) : 0.f;
    }
    const float* kr = k + row * kk * e;
    const float* vr = v + row * kk * e;
    const uint8_t* ok = valid + row * kk;

    // scores: lane t keeps slot c * 32 + t in sc[c]; -inf past the K slots
    float sc[NA_KPL];
    bool any = false;
#pragma unroll
    for (int c = 0; c < NA_KPL; ++c) {
        sc[c] = -INFINITY;
        if (c * 32 >= kk) continue;            // the same for the whole warp
        const int s_lane = c * 32 + lane;
        if (s_lane < kk && __ldg(ok + s_lane)) any = true;
#pragma unroll 4
        for (int t = 0; t < 32; ++t) {
            const int s = c * 32 + t;
            if (s >= kk) break;
            float p = 0.f;
#pragma unroll
            for (int u = 0; u < EPL; ++u) {
                const int j = u * 32 + lane;
                if (j < e) p = fmaf(qr[u], __ldg(kr + (int64_t)s * e + j), p);
            }
            p = warp_sum(p);
            if (lane == t) sc[c] = __ldg(ok + s) ? p / div : -1e30f;
        }
    }
    any = __any_sync(FULL, any);

    float mx = sc[0];
#pragma unroll
    for (int c = 1; c < NA_KPL; ++c) mx = fmaxf(mx, sc[c]);
    mx = warp_max(mx);
    float ex[NA_KPL];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NA_KPL; ++c) {
        ex[c] = expf(sc[c] - mx);              // 0 for masked and past-K slots
        sum += ex[c];
    }
    sum = warp_sum(sum);

    float acc[EPL];
#pragma unroll
    for (int u = 0; u < EPL; ++u) acc[u] = 0.f;
    if (any) {
#pragma unroll
        for (int c = 0; c < NA_KPL; ++c) {
            if (c * 32 >= kk) continue;
#pragma unroll 4
            for (int t = 0; t < 32; ++t) {
                const int s = c * 32 + t;
                if (s >= kk) break;
                const float p = __shfl_sync(FULL, ex[c], t) / sum;
#pragma unroll
                for (int u = 0; u < EPL; ++u) {
                    const int j = u * 32 + lane;
                    if (j < e) acc[u] = fmaf(p, __ldg(vr + (int64_t)s * e + j),
                                             acc[u]);
                }
            }
        }
    }
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
        const int j = u * 32 + lane;
        if (j < e) out[row * e + j] = acc[u];
    }
}

template <int EPL>
int launch(const void* q, const void* k, const void* v, const void* valid,
           int m, int kk, int e, float div, void* out, cudaStream_t st) {
    const int blocks = (m + NA_WARPS - 1) / NA_WARPS;
    neighbor_attn_kernel<EPL><<<blocks, NA_WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const uint8_t*>(valid), m,
        kk, e, div, static_cast<float*>(out));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_neighbor_attn(
        const void* q, const void* k, const void* v, const void* valid, int m,
        int kk, int e, float div, void* out, void* stream) {
    if (m <= 0) return 0;
    if (kk < 1 || kk > NA_MAX_K || e < 1 || e > 256)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (e <= 32) return launch<1>(q, k, v, valid, m, kk, e, div, out, st);
    if (e <= 64) return launch<2>(q, k, v, valid, m, kk, e, div, out, st);
    if (e <= 128) return launch<4>(q, k, v, valid, m, kk, e, div, out, st);
    return launch<8>(q, k, v, valid, m, kk, e, div, out, st);
}
