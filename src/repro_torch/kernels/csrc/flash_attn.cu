// flash_attn on float32 inputs for Hopper (sm_90a), plain C interface for
// ctypes. bfloat16 inputs take csrc/flash_attn_wgmma.cu (tensor cores).
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_attn_pallas (body
// _flash_kernel) for float32 q, k and v: attention of G query groups over
// Gkv kv groups, group g reading kv group g / (G / Gkv) (GQA without
// expanding k and v):
//   s_ij = (q_i . k_j) / sqrt(D), set to -1e30 where masked (k_pos > q_pos
//          when causal, k_pos <= q_pos - window when windowed)
//   out_i = sum_j softmax_j(s_i.) v_j
// with the TPU kernel's online softmax over kv tiles: a running max m
// (from -1e30), denominator l and fp32 accumulator, rescaled by
// exp(m_old - m_new) at each tile, and out = acc / max(l, 1e-30). Every
// product runs in fp32, as the TPU kernel's (preferred_element_type=
// float32).
//
// The TPU kernel walks (group, q block, kv block) in order with the
// statistics in VMEM scratch. Here one block of 256 threads owns a
// (group, 64-row query tile): four neighbouring lanes share a query row,
// each holding every fourth float4 of q and of the accumulator in
// registers. The block stages 64-key tiles of K and V in shared memory as
// fp32 (zero-padded past D and past T); the warp's eight rows read the
// same shared addresses (broadcast) and the row's four lanes read
// consecutive float4s. A score is the four lanes' partial dots summed
// with two shuffles; lane t of a row keeps the scores of keys j = t mod 4,
// so the tile's max and sum are reductions over registers, and each
// probability is shuffled to the row's lanes for the P.V update.
//
// Tiles wholly above the diagonal (causal) or wholly outside the window
// are skipped: a masked score weighs exp(-1e30 - m) = 0 once a row has a
// valid key, and every row has one (k_pos = q_pos, or the last key when
// T < S), except when a window leaves a row of the tile with no valid key
// at all; such a tile of queries takes every kv tile, as the plain
// version does (its masked row is the mean of v). Keys past T are -inf
// (weight exactly 0).
//
// Bound on this card: operations. A causal launch at the prefill shape
// (G = 32, S = T = 8192, D = 128) needs about 550 GFLOP (two products of
// S^2 D / 2 per group), 8.2 ms at the 67 TFLOP/s fp32 rate, and moves
// about 200 MB (0.06 ms). This kernel runs on the fp32 FMA units only (an
// fp32 product has no exact tensor-core form). exp is expf, not __expf (no
// --use_fast_math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FA_BQ = 64;                 // query rows per block
constexpr int FA_BK = 64;                 // keys per staged tile
constexpr int FA_TPR = 4;                 // lanes per query row
constexpr int FA_THREADS = FA_BQ * FA_TPR;
constexpr int FA_MAX_D = 256;
constexpr int FA_SPT = FA_BK / FA_TPR;    // scores a lane keeps per tile
constexpr float FA_NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    return x;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
    x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
    return x;
}

// NV: float4 chunks a lane holds, so D <= 16 * NV (the padded width DP)
template <int NV>
__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, int n_rep, int s_len, int t_len, int d,
        int causal, int window, float div, float* __restrict__ out) {
    constexpr int DP = 16 * NV;
    extern __shared__ float4 fa_smem[];
    float* ks = reinterpret_cast<float*>(fa_smem);   // [FA_BK][DP]
    float* vs = ks + FA_BK * DP;                     // [FA_BK][DP]

    const int n_qt = (s_len + FA_BQ - 1) / FA_BQ;
    // the longest causal tiles (the last query tiles) start first
    const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
    const int64_t g = blockIdx.x / n_qt;
    const int64_t gkv = g / n_rep;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int sub = tid & (FA_TPR - 1);
    const int q0 = qt * FA_BQ;
    const int qi = q0 + tid / FA_TPR;                // this lane's query row
    const bool row_ok = qi < s_len;

    // q: chunk c = i * 4 + sub of the row, as fp32 (0 past D or S)
    float4 qr[NV];
    float4 acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int col = (i * FA_TPR + sub) * 4 + u;
            e[u] = (row_ok && col < d)
                ? q[(g * s_len + qi) * (int64_t)d + col] : 0.f;
        }
        qr[i] = make_float4(e[0], e[1], e[2], e[3]);
        acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float m = FA_NEG, l = 0.f;

    // kv tiles this query tile visits
    const int q_last = min(q0 + FA_BQ, s_len) - 1;
    const int n_kt = (t_len + FA_BK - 1) / FA_BK;
    int kt_lo = 0, kt_hi = n_kt;                     // [kt_lo, kt_hi)
    // a windowed row of this tile with no valid key in [0, T) ends the
    // skipping (then every tile is taken, as the plain version does)
    const bool skip_ok = window <= 0 || q_last - window < t_len - 1;
    if (skip_ok) {
        if (causal) kt_hi = min(n_kt, q_last / FA_BK + 1);
        if (window > 0) kt_lo = max(0, (q0 - window + 1) / FA_BK);
    }

    const float* kg = k + gkv * t_len * (int64_t)d;
    const float* vg = v + gkv * t_len * (int64_t)d;
    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();                             // the last tile is read
        for (int e = tid; e < FA_BK * DP; e += FA_THREADS) {
            const int r = e / DP, col = e - r * DP;
            const int key = k0 + r;
            const bool ok = key < t_len && col < d;
            const int64_t off = (int64_t)key * d + col;
            ks[e] = ok ? kg[off] : 0.f;
            vs[e] = ok ? vg[off] : 0.f;
        }
        __syncthreads();

        // scores: lane sub keeps key j = jj * 4 + sub in sc[jj]
        float sc[FA_SPT];
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < FA_BK; ++j) {
            const float4* kr = reinterpret_cast<const float4*>(ks + j * DP);
            float p = 0.f;
#pragma unroll
            for (int i = 0; i < NV; ++i) {
                const float4 kk = kr[i * FA_TPR + sub];
                p = fmaf(qr[i].x, kk.x, p);
                p = fmaf(qr[i].y, kk.y, p);
                p = fmaf(qr[i].z, kk.z, p);
                p = fmaf(qr[i].w, kk.w, p);
            }
            p = quad_sum(p);
            const int key = k0 + j;
            float s;
            if (key >= t_len) {
                s = -INFINITY;
            } else {
                bool ok = true;
                if (causal) ok = key <= qi;
                if (window > 0) ok = ok && key > qi - window;
                s = ok ? p / div : FA_NEG;
            }
            if ((j & (FA_TPR - 1)) == sub) {
                sc[j / FA_TPR] = s;
                tmax = fmaxf(tmax, s);
            }
        }
        const float m_new = fmaxf(m, quad_max(tmax));
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < FA_SPT; ++jj) {
            sc[jj] = expf(sc[jj] - m_new);
            psum += sc[jj];
        }
        l = l * alpha + quad_sum(psum);
        m = m_new;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            acc[i].x *= alpha; acc[i].y *= alpha;
            acc[i].z *= alpha; acc[i].w *= alpha;
        }
        const int base = lane & ~(FA_TPR - 1);
#pragma unroll
        for (int j = 0; j < FA_BK; ++j) {
            const float p = __shfl_sync(FULL, sc[j / FA_TPR],
                                        base + (j & (FA_TPR - 1)));
            const float4* vr = reinterpret_cast<const float4*>(vs + j * DP);
#pragma unroll
            for (int i = 0; i < NV; ++i) {
                const float4 vv = vr[i * FA_TPR + sub];
                acc[i].x = fmaf(p, vv.x, acc[i].x);
                acc[i].y = fmaf(p, vv.y, acc[i].y);
                acc[i].z = fmaf(p, vv.z, acc[i].z);
                acc[i].w = fmaf(p, vv.w, acc[i].w);
            }
        }
    }

    if (!row_ok) return;
    const float den = fmaxf(l, 1e-30f);
    float* o = out + (g * s_len + qi) * (int64_t)d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
        const int col = (i * FA_TPR + sub) * 4;
        const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (col + u < d) o[col + u] = e[u] / den;
    }
}

template <int NV>
int launch(const void* q, const void* k, const void* v, int g, int n_rep,
           int s, int t, int d, int causal, int window, float div, void* out,
           cudaStream_t st) {
    const size_t smem = 2 * (size_t)FA_BK * 16 * NV * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)g * ((s + FA_BQ - 1) / FA_BQ);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    flash_attn_kernel<NV><<<(unsigned)blocks, FA_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), n_rep, s, t, d, causal, window, div,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, int g, int n_rep,
               int s, int t, int d, int causal, int window, float div,
               void* out, cudaStream_t st) {
    // three widths only (each instantiation unrolls 64 keys and costs
    // build time); a narrower head is zero-padded to the next one
    if (d <= 64) return launch<4>(q, k, v, g, n_rep, s, t, d, causal,
                                  window, div, out, st);
    if (d <= 128) return launch<8>(q, k, v, g, n_rep, s, t, d, causal,
                                   window, div, out, st);
    return launch<16>(q, k, v, g, n_rep, s, t, d, causal, window, div, out,
                      st);
}

}  // namespace

// q, k, v and out float32; window 0 = none
extern "C" int repro_flash_attn(
        const void* q, const void* k, const void* v, int g, int gkv, int s,
        int t, int d, int causal, int window, float div, void* out,
        void* stream) {
    if (g <= 0 || s <= 0) return 0;
    if (gkv < 1 || g % gkv || t < 1 || d < 1 || d > FA_MAX_D || window < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rep = g / gkv;
    return dispatch_d(q, k, v, g, n_rep, s, t, d, causal, window, div, out,
                      st);
}
