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
// MXU with the weight panels whole in VMEM. Here a block owns a tile of
// GC_ROWS rows and GC_COLS output columns j, and runs both products on the
// tensor cores at fp32 grade (three TF32 products a step, tf32x3.cuh). Its
// eight warps split the depth: four take x W, four h U, each warp 16 rows
// x the 16 columns with, per 8-column group, one accumulator tile per gate
// panel. The h half hands its sums to the x half through shared memory,
// which adds them (r = x W_r + h U_r, z likewise; x W_n and h U_n stay
// apart, since r multiplies the latter) and forms the gates, the bias and
// h' from the registers, with no second pass through memory. Both halves'
// depth chunks stream through a three-stage cp.async ring (GC_KC deep:
// the row tile's chunk and the three gate panels of W or U the block's
// columns need; 16-byte copies where the widths allow), so no width is
// limited by shared memory. Rows past M and columns past D are
// zero-filled in the ring and never written.
//
// Bound on this card: 2 * M * (Din + D) * 3D FLOPs plus the gate math
// (0.20 GFLOP at M = 2000, D = Din = 128) against 3.5 MB of rows and
// weights: a few microseconds on either unit. At these sizes the time goes
// to the launch, the ring's fill and the instructions around the products
// (fragment loads, operand splits; timed on the H100, the mma.sync
// themselves hide behind them), so the depth is split across twice the
// warps. M = 2000, D = 128 gives 32 x 8 = 256 blocks of 256 threads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int GC_ROWS = 64;      // rows per block: a 16-row mma tile a warp
constexpr int GC_COLS = 16;      // output columns per block: two 8-wide groups
constexpr int GC_THREADS = 256;  // two halves of four warps: x W and h U
constexpr int GC_KC = 32;        // depth of one pipeline stage
constexpr int GC_STAGES = 3;
constexpr int GC_LDA = GC_KC + 4;          // 36: 4 mod 8
constexpr int GC_LDB = 3 * GC_COLS + 8;    // 56: 24 mod 32
constexpr int GC_HALF = GC_ROWS * GC_LDA + GC_KC * GC_LDB;
constexpr int GC_STAGE = 2 * GC_HALF;      // an x chunk and an h chunk

__device__ __forceinline__ float gc_sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// VEC: Din and D multiples of 4 and every pointer 16-byte aligned, so the
// ring is filled by 16-byte copies; else by 4-byte ones
template <bool VEC>
__global__ void __launch_bounds__(GC_THREADS) gru_cell_kernel(
        const float* __restrict__ x, int din,
        const float* __restrict__ h, int d,
        const float* __restrict__ w, const float* __restrict__ u,
        const float* __restrict__ b, int m, float* __restrict__ out) {
    extern __shared__ __align__(16) float ring[];   // GC_STAGES x GC_STAGE
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int half = warp >> 2;            // 0: x W, 1: h U
    const int row_w = (warp & 3) * 16;     // the warp's rows in the tile
    const int htid = tid & (GC_THREADS / 2 - 1);
    const int row0 = blockIdx.x * GC_ROWS;
    const int col0 = blockIdx.y * GC_COLS;
    const int64_t d3 = 3 * (int64_t)d;
    const float* a = half ? h : x;         // this half's rows and panels
    const float* wt = half ? u : w;
    const int kd = half ? d : din;
    const int nk = (kd + GC_KC - 1) / GC_KC;
    const int ns = max((din + GC_KC - 1) / GC_KC, (d + GC_KC - 1) / GC_KC);

    // step c into ring slot c % GC_STAGES: each half copies its chunk c (if
    // it has one): the row tile's columns k0 .. k0 + GC_KC - 1 of x (or h)
    // and those rows of the gate panels of W (or U) at the block's columns
    // (r, z, n side by side)
    auto issue = [&](int c) {
        float* as = ring + (c % GC_STAGES) * GC_STAGE + half * GC_HALF;
        float* bs = as + GC_ROWS * GC_LDA;
        if (c >= nk) return;
        const int k0 = c * GC_KC;
        if (VEC) {
            for (int e = htid; e < GC_ROWS * GC_KC / 4; e += GC_THREADS / 2) {
                const int r = e / (GC_KC / 4), k = 4 * (e % (GC_KC / 4));
                const int n = min(4, max(0, kd - k0 - k));
                cp_async16(as + r * GC_LDA + k,
                           a + (int64_t)(row0 + r) * kd + k0 + k,
                           row0 + r < m ? 4 * n : 0, a);
            }
            for (int e = htid; e < GC_KC * 3 * GC_COLS / 4;
                 e += GC_THREADS / 2) {
                const int k = e / (3 * GC_COLS / 4);
                const int n = 4 * (e % (3 * GC_COLS / 4));
                const int gate = n / GC_COLS, j = col0 + n % GC_COLS;
                const int live = min(4, max(0, d - j));
                cp_async16(bs + k * GC_LDB + n,
                           wt + (int64_t)(k0 + k) * d3 + (int64_t)gate * d + j,
                           k0 + k < kd ? 4 * live : 0, wt);
            }
        } else {
            for (int e = htid; e < GC_ROWS * GC_KC; e += GC_THREADS / 2) {
                const int r = e / GC_KC, k = e % GC_KC;
                const bool ok = row0 + r < m && k0 + k < kd;
                cp_async4(as + r * GC_LDA + k,
                          a + (int64_t)(row0 + r) * kd + k0 + k, ok, a);
            }
            for (int e = htid; e < GC_KC * 3 * GC_COLS; e += GC_THREADS / 2) {
                const int k = e / (3 * GC_COLS), n = e % (3 * GC_COLS);
                const int gate = n / GC_COLS, j = col0 + n % GC_COLS;
                const bool ok = k0 + k < kd && j < d;
                cp_async4(bs + k * GC_LDB + n,
                          wt + (int64_t)(k0 + k) * d3 + (int64_t)gate * d + j,
                          ok, wt);
            }
        }
    };

    // per 8-wide column group cg: acc[cg][0] r, [1] z, [2] n (x W_n in the
    // x half, h U_n in the h half), each over this half's depth
    float acc[2][3][4];
#pragma unroll
    for (int cg = 0; cg < 2; ++cg)
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[cg][i][j] = 0.0f;

    for (int s = 0; s < GC_STAGES - 1; ++s) {
        if (s < ns) issue(s);
        cp_async_commit();
    }
    for (int c = 0; c < ns; ++c) {
        cp_async_wait<GC_STAGES - 2>();
        __syncthreads();   // step c landed; slot (c - 1) % 3 is free
        if (c + GC_STAGES - 1 < ns) issue(c + GC_STAGES - 1);
        cp_async_commit();
        if (c >= nk) continue;
        const float* as = ring + (c % GC_STAGES) * GC_STAGE + half * GC_HALF;
        const float* bs = as + GC_ROWS * GC_LDA;
#pragma unroll
        for (int ks = 0; ks < GC_KC; ks += 8) {
            const FragA fa = load_frag_a<false>(as, GC_LDA, row_w, ks, GC_KC);
#pragma unroll
            for (int cg = 0; cg < 2; ++cg)
#pragma unroll
                for (int gate = 0; gate < 3; ++gate)
                    mma_3xtf32(acc[cg][gate], fa,
                               load_frag_b(bs, GC_LDB, ks,
                                           gate * GC_COLS + cg * 8));
        }
    }

    // the h half hands its sums to the x half through the ring, each
    // thread's 24 values at [warp & 3][value][lane]
    cp_async_wait<0>();
    __syncthreads();
    float* red = ring + (warp & 3) * 24 * 32 + lane;
    if (half) {
#pragma unroll
        for (int cg = 0; cg < 2; ++cg)
#pragma unroll
            for (int gate = 0; gate < 3; ++gate)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    red[((cg * 3 + gate) * 4 + i) * 32] = acc[cg][gate][i];
    }
    __syncthreads();
    if (half) return;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int cg = 0; cg < 2; ++cg)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = row0 + row_w + g + (i >> 1) * 8;
            const int j = col0 + cg * 8 + 2 * t + (i & 1);
            if (row < m && j < d) {
                const float hr = red[((cg * 3 + 0) * 4 + i) * 32];
                const float hz = red[((cg * 3 + 1) * 4 + i) * 32];
                const float hn = red[((cg * 3 + 2) * 4 + i) * 32];
                const float hv = h[(int64_t)row * d + j];
                // the plain version's order: (x W + b) + h U
                const float rg = gc_sigmoid((acc[cg][0][i] + b[j]) + hr);
                const float zg = gc_sigmoid((acc[cg][1][i] + b[d + j]) + hz);
                const float ng =
                    tanhf((acc[cg][2][i] + b[2 * d + j]) + rg * hn);
                out[(int64_t)row * d + j] = (1.0f - zg) * hv + zg * ng;
            }
        }
}

}  // namespace

extern "C" int repro_gru_cell(
        const void* x, int din, const void* h, int d, const void* w,
        const void* u, const void* b, int m, void* out, void* stream) {
    if (m <= 0) return 0;
    if (din < 1 || d < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((m + GC_ROWS - 1) / GC_ROWS, (d + GC_COLS - 1) / GC_COLS);
    auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vec = din % 4 == 0 && d % 4 == 0 && aligned(x) &&
                     aligned(h) && aligned(w) && aligned(u);
    const auto kernel = vec ? gru_cell_kernel<true> : gru_cell_kernel<false>;
    const int smem = (int)sizeof(float) * GC_STAGES * GC_STAGE;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, GC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), din, static_cast<const float*>(h), d,
        static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<const float*>(b), m, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
