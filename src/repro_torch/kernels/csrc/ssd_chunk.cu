// ssd_chunk for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ssd_chunk.py::_ssd_chunk_pallas (body
// _ssd_kernel): one chunk of the chunked linear recurrence for each of G
// groups (batch x heads), in fp32. Per group, with q, k (L, N), v (L, P),
// lcum (L) the inclusive cumulative log-decay and h0 (N, P) the carried
// state:
//   y  = ((q k^T) * exp(lcum_i - lcum_j) [j <= i]) v + (q * exp(lcum)) h0
//   h1 = exp(ltot) h0 + (k * exp(ltot - lcum))^T v,   ltot = lcum[L - 1]
//
// The TPU kernel holds a whole group (its L x L score block and every
// operand) in VMEM, one grid step a group, for N, P <= 128. At the xLSTM
// widths (L = 256, N = 256, P = 257) the score block alone is 256 KB, more
// than a block's shared memory, and one block a group would put a batch
// of 2 (G = 8) on 8 of the 132 SMs. So the work is split over blocks of 16
// output rows: ceil(L / 16) blocks a group each own 16 rows of y, and
// ceil(N / 16) blocks own 16 rows of h1 (G = 8: 256 blocks). Every block
// runs the same inner loop, acc[r][p] += c[j][r] * x[j][p] over 32-row
// tiles staged in shared memory: each thread owns the columns p = tid and
// p = tid + 256 (P need not be a multiple of anything: P = 257 leaves a
// second column to thread 0 only), c[j][0..15] is read as four broadcast
// float4s, x[j][p] by consecutive threads.
//  - a y block first takes (q * exp(lcum)) against h0 in 32-row slices of
//    N (c = the scaled q rows, held transposed), then for each key tile
//    j0 <= its last row forms the masked decayed scores c[j][r] =
//    (q_r . k_j) * exp(lcum_r - lcum_j) for j <= r, else exactly 0 (dots
//    of length N over a K tile padded to N + 1 columns against bank
//    conflicts) and takes them against the V tile;
//  - an h1 block takes c[j][r] = k[j][n0 + r] * exp(ltot - lcum_j) against
//    the V tiles, then adds exp(ltot) h0.
// Each product is rounded as the plain version's (the score, then its
// decay; the scaled q; the weighted k), and the sums run in another order.
//
// Bound on this card: operations, about 135 MFLOP a group at the xLSTM
// widths (1.08 GFLOP a launch at G = 8: 0.016 ms at the 67 TFLOP/s fp32
// rate) against 10.5 MB moved (0.003 ms); at that size the launch and the
// blocks' serial tile loop dominate. exp is expf (no --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SSD_THREADS = 256;
constexpr int SSD_R = 16;                 // output rows a block owns
constexpr int SSD_J = 32;                 // rows of a staged tile
constexpr int SSD_MAX_N = 256;
constexpr int SSD_MAX_P = 2 * SSD_THREADS;

// acc[r][c] += coef[j][r] * x[j][p_c] for the SSD_J staged rows
__device__ __forceinline__ void accumulate(
        float (&acc)[SSD_R][2], const float* __restrict__ coef,
        const float* __restrict__ x, int p_dim, int tid) {
    const bool two = tid + SSD_THREADS < p_dim;
#pragma unroll 4
    for (int j = 0; j < SSD_J; ++j) {
        const float4* c4 = reinterpret_cast<const float4*>(coef + j * SSD_R);
        float c[SSD_R];
#pragma unroll
        for (int u = 0; u < SSD_R / 4; ++u) {
            const float4 t = c4[u];
            c[4 * u] = t.x; c[4 * u + 1] = t.y;
            c[4 * u + 2] = t.z; c[4 * u + 3] = t.w;
        }
        const float* xr = x + j * p_dim;
        if (tid < p_dim) {
            const float x0 = xr[tid];
#pragma unroll
            for (int r = 0; r < SSD_R; ++r) acc[r][0] = fmaf(c[r], x0, acc[r][0]);
        }
        if (two) {
            const float x1 = xr[tid + SSD_THREADS];
#pragma unroll
            for (int r = 0; r < SSD_R; ++r) acc[r][1] = fmaf(c[r], x1, acc[r][1]);
        }
    }
}

// rows [lo, lo + SSD_J) of a (rows, p_dim) matrix into x, zeros past rows
__device__ __forceinline__ void stage_rows(
        float* __restrict__ x, const float* __restrict__ src, int lo,
        int rows, int p_dim, int tid) {
    for (int e = tid; e < SSD_J * p_dim; e += SSD_THREADS) {
        const int r = e / p_dim;
        x[e] = lo + r < rows ? src[(int64_t)(lo + r) * p_dim + (e - r * p_dim)]
                             : 0.f;
    }
}

__global__ void __launch_bounds__(SSD_THREADS) ssd_chunk_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ lcum,
        const float* __restrict__ h0, int l_len, int n_dim, int p_dim,
        float* __restrict__ y, float* __restrict__ h1) {
    extern __shared__ float4 ssd_smem4[];
    float* smem = reinterpret_cast<float*>(ssd_smem4);
    // coef [SSD_J][SSD_R] | x [SSD_J][P] | (y blocks) qT, qsT [N][SSD_R],
    // k tile [SSD_J][N + 1]
    float* coef = smem;
    float* x = coef + SSD_J * SSD_R;
    float* qt = x + SSD_J * p_dim;
    float* qst = qt + n_dim * SSD_R;
    float* kt = qst + n_dim * SSD_R;

    const int n_yb = (l_len + SSD_R - 1) / SSD_R;
    const int n_hb = (n_dim + SSD_R - 1) / SSD_R;
    const int64_t g = blockIdx.x / (n_yb + n_hb);
    const int b = blockIdx.x % (n_yb + n_hb);
    const int tid = threadIdx.x;
    const float* qg = q + g * l_len * (int64_t)n_dim;
    const float* kg = k + g * l_len * (int64_t)n_dim;
    const float* vg = v + g * l_len * (int64_t)p_dim;
    const float* lg = lcum + g * (int64_t)l_len;
    const float* hg = h0 + g * n_dim * (int64_t)p_dim;

    float acc[SSD_R][2];
#pragma unroll
    for (int r = 0; r < SSD_R; ++r) acc[r][0] = acc[r][1] = 0.f;

    if (b < n_yb) {
        // ---- 16 rows of y: i in [i0, i0 + 16)
        const int i0 = b * SSD_R;
        for (int e = tid; e < n_dim * SSD_R; e += SSD_THREADS) {
            const int n = e / SSD_R, r = e - n * SSD_R;
            const int i = i0 + r;
            const float qv = i < l_len ? qg[(int64_t)i * n_dim + n] : 0.f;
            qt[e] = qv;
            qst[e] = i < l_len ? qv * expf(lg[i]) : 0.f;
        }
        // carry-in: (q * exp(lcum)) h0, in slices of SSD_J rows of h0
        for (int n0 = 0; n0 < n_dim; n0 += SSD_J) {
            __syncthreads();
            stage_rows(x, hg, n0, n_dim, p_dim, tid);
            __syncthreads();
            // the slice's coefficients are qsT's rows n0.. (zeros past N
            // multiply the zero rows staged past N)
            if (n0 + SSD_J <= n_dim) {
                accumulate(acc, qst + n0 * SSD_R, x, p_dim, tid);
            } else {
                for (int e = tid; e < SSD_J * SSD_R; e += SSD_THREADS)
                    coef[e] = n0 * SSD_R + e < n_dim * SSD_R
                        ? qst[n0 * SSD_R + e] : 0.f;
                __syncthreads();
                accumulate(acc, coef, x, p_dim, tid);
            }
        }
        // intra-chunk: key tiles up to the block's last row
        const int i_last = min(i0 + SSD_R, l_len) - 1;
        const int np1 = n_dim + 1;
        for (int j0 = 0; j0 <= i_last; j0 += SSD_J) {
            __syncthreads();
            for (int e = tid; e < SSD_J * n_dim; e += SSD_THREADS) {
                const int jj = e / n_dim, n = e - jj * n_dim;
                kt[jj * np1 + n] = j0 + jj < l_len
                    ? kg[(int64_t)(j0 + jj) * n_dim + n] : 0.f;
            }
            stage_rows(x, vg, j0, l_len, p_dim, tid);
            __syncthreads();
            // scores: thread -> key jj = tid % 32, rows r and r + 8
            {
                const int jj = tid & (SSD_J - 1);
                const int r0 = tid / SSD_J;            // 0..7
                const int j = j0 + jj;
                float d0 = 0.f, d1 = 0.f;
                const float* kr = kt + jj * np1;
                for (int n = 0; n < n_dim; ++n) {
                    const float kv = kr[n];
                    d0 = fmaf(qt[n * SSD_R + r0], kv, d0);
                    d1 = fmaf(qt[n * SSD_R + r0 + 8], kv, d1);
                }
                const float lj = j < l_len ? lg[j] : 0.f;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 8 * h;
                    const int i = i0 + r;
                    const float dot = h ? d1 : d0;
                    coef[jj * SSD_R + r] = (j <= i && i < l_len)
                        ? dot * expf(lg[i] - lj) : 0.f;
                }
            }
            __syncthreads();
            accumulate(acc, coef, x, p_dim, tid);
        }
#pragma unroll
        for (int r = 0; r < SSD_R; ++r) {
            const int i = i0 + r;
            if (i >= l_len) break;
            float* yr = y + (g * l_len + i) * (int64_t)p_dim;
            if (tid < p_dim) yr[tid] = acc[r][0];
            if (tid + SSD_THREADS < p_dim) yr[tid + SSD_THREADS] = acc[r][1];
        }
    } else {
        // ---- 16 rows of h1: n in [n0, n0 + 16)
        const int n0 = (b - n_yb) * SSD_R;
        const float ltot = lg[l_len - 1];
        for (int j0 = 0; j0 < l_len; j0 += SSD_J) {
            __syncthreads();
            stage_rows(x, vg, j0, l_len, p_dim, tid);
            for (int e = tid; e < SSD_J * SSD_R; e += SSD_THREADS) {
                const int jj = e / SSD_R, r = e - jj * SSD_R;
                const int j = j0 + jj, n = n0 + r;
                coef[e] = (j < l_len && n < n_dim)
                    ? kg[(int64_t)j * n_dim + n] * expf(ltot - lg[j]) : 0.f;
            }
            __syncthreads();
            accumulate(acc, coef, x, p_dim, tid);
        }
        const float decay = expf(ltot);
#pragma unroll
        for (int r = 0; r < SSD_R; ++r) {
            const int n = n0 + r;
            if (n >= n_dim) break;
            const float* hr = hg + (int64_t)n * p_dim;
            float* outr = h1 + (g * n_dim + n) * (int64_t)p_dim;
            if (tid < p_dim) outr[tid] = hr[tid] * decay + acc[r][0];
            if (tid + SSD_THREADS < p_dim)
                outr[tid + SSD_THREADS] =
                    hr[tid + SSD_THREADS] * decay + acc[r][1];
        }
    }
}

}  // namespace

extern "C" int repro_ssd_chunk(
        const void* q, const void* k, const void* v, const void* lcum,
        const void* h0, int g, int l_len, int n_dim, int p_dim, void* y,
        void* h1, void* stream) {
    if (g <= 0) return 0;
    if (l_len < 1 || n_dim < 1 || n_dim > SSD_MAX_N || p_dim < 1
            || p_dim > SSD_MAX_P)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * (
        (size_t)SSD_J * SSD_R + (size_t)SSD_J * p_dim
        + 2 * (size_t)n_dim * SSD_R + (size_t)SSD_J * (n_dim + 1));
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int per_g = (l_len + SSD_R - 1) / SSD_R
        + (n_dim + SSD_R - 1) / SSD_R;
    const int64_t blocks = (int64_t)g * per_g;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    ssd_chunk_kernel<<<(unsigned)blocks, SSD_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(lcum),
        static_cast<const float*>(h0), l_len, n_dim, p_dim,
        static_cast<float*>(y), static_cast<float*>(h1));
    return (int)cudaGetLastError();
}
