// embed_attn for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/embed_attn.py::_embed_attn_pallas (body
// _embed_attn_kernel). For each parent row r of the compacted frontier:
//   q      = h_self[r] @ Wq                                   (E)
//   kv_j   = [tab[idx[r, j]], cos(dt[r, j] * tw + tb)]        (Din + d_time)
//   k_j    = kv_j @ Wk,  v_j = kv_j @ Wv                      (E each)
//   per head h (width dh = E / H): s_j = q_h . k_j,h / sqrt(dh), masked
//   softmax over the valid slots (a row with no valid slot gives exactly 0),
//   out[r, h] = sum_j p_j v_j,h                               (R, E)
//
// The TPU kernel carries an online softmax in scratch across a sequential
// grid axis over the K slots. Here one block owns the 64 / K parent rows
// whose 64 (row, neighbour) slots it holds at once in shared memory, so
// the softmax is a plain two-pass one inside the block and no state
// crosses blocks.
//
// Bound on this card: the K/V projections, 4 * R * K * (Din + d_time) * E
// FLOPs, against R * K row gathers: the fp32 FMA rate bounds it. The block
// computes its (64 slots) x (2E) K|V tile as a register-tiled product:
// the gathered, time-encoded slot tile sits transposed in shared memory,
// Wk|Wv rows are staged through shared memory EA_KC rows at a time (Wk + Wv
// are 196 KB at d = 128, d_time = 64: they do not fit whole next to the
// tile), and each thread accumulates an 8 slot x 8 column tile from two
// 16-byte loads of each operand per step. fp32 FMA, no tensor cores yet.
// The angle is one fmaf (one rounding, as jitted XLA forms it) and the
// cosine is cosf, not __cosf: dt * tw reaches 1e5, where the fast
// intrinsic is badly wrong, so the build never uses --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int EA_THREADS = 256;
constexpr int EA_SLOTS = 64;             // (row, neighbour) slots per block
constexpr int EA_LD = EA_SLOTS + 4;      // row stride of the transposed tile
constexpr int EA_KC = 16;                // weight rows staged per step
constexpr int EA_T = 8;                  // thread tile: 8 slots x 8 columns
constexpr int EA_MAX_E = 128;            // 2E / EA_T column groups <= 32

__host__ __device__ __forceinline__ int align4(int x) { return (x + 3) & ~3; }

// float offsets of the shared-memory regions (host and device agree)
struct Layout {
    int a_size, hs, qs, ps, total;
    __host__ __device__ Layout(int c, int e, int ds, int br, int n_heads,
                               int kk) {
        const int tile = align4(c * EA_LD) + EA_KC * 2 * e;
        a_size = align4(tile > EA_SLOTS * 2 * e ? tile : EA_SLOTS * 2 * e);
        hs = a_size;
        qs = hs + align4(br * ds);
        ps = qs + align4(br * e);
        total = ps + align4(br * n_heads * kk);
    }
};

__global__ void __launch_bounds__(EA_THREADS) embed_attn_kernel(
        const float* __restrict__ h_self, int ds,
        const float* __restrict__ tab, int din,
        const int32_t* __restrict__ idx, const float* __restrict__ dt,
        const uint8_t* __restrict__ valid, int r_total, int kk,
        const float* __restrict__ tw, const float* __restrict__ tb,
        int dtime,
        const float* __restrict__ wq, const float* __restrict__ wk,
        const float* __restrict__ wv, int e, int n_heads, int br,
        float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int c = din + dtime;
    const int e2 = 2 * e;
    const int nslot = br * kk;
    const Layout lay(c, e, ds, br, n_heads, kk);
    float* kvt = smem;                        // c x EA_LD, slot tile (k-major)
    float* wst = smem + align4(c * EA_LD);    // EA_KC x 2E staged Wk | Wv
    float* kvo = smem;                        // EA_SLOTS x 2E, after the product
    float* hs = smem + lay.hs;                // br x ds
    float* qs = smem + lay.qs;                // br x e
    float* ps = smem + lay.ps;                // br x n_heads x kk
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * br;
    const int nrows = min(br, r_total - row0);

    for (int i = tid; i < br * ds; i += blockDim.x) {
        const int r = i / ds;
        hs[i] = (r < nrows) ? h_self[(int64_t)(row0 + r) * ds + (i - r * ds)]
                            : 0.0f;
    }
    // the block's slots: gather index (-1 = empty) and time gap
    __shared__ int sidx[EA_SLOTS];
    __shared__ float sdt[EA_SLOTS];
    for (int s = tid; s < EA_SLOTS; s += blockDim.x) {
        const int r = s / kk;
        const bool live = s < nslot && r < nrows;
        const int64_t rk = (int64_t)(row0 + r) * kk + (s - r * kk);
        sidx[s] = live ? idx[rk] : -1;
        sdt[s] = live ? dt[rk] : 0.0f;
    }
    __syncthreads();
    // transposed slot tile: gathered rows, then the time encoding; the
    // loops carry no dependence, so unrolling keeps several gathers in flight
#pragma unroll 4
    for (int i = tid; i < EA_SLOTS * din; i += blockDim.x) {
        const int s = i / din;
        const int k = i - s * din;
        const int g = sidx[s];
        kvt[k * EA_LD + s] = g >= 0 ? tab[(int64_t)g * din + k] : 0.0f;
    }
    for (int i = tid; i < EA_SLOTS * dtime; i += blockDim.x) {
        const int s = i / dtime;
        const int q = i - s * dtime;
        kvt[(din + q) * EA_LD + s] =
            sidx[s] >= 0 ? cosf(fmaf(sdt[s], tw[q], tb[q])) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < br * e; i += blockDim.x) {
        const int r = i / e;
        const int col = i - r * e;
        float a = 0.0f;
        for (int k = 0; k < ds; ++k)
            a = fmaf(hs[r * ds + k], __ldg(wq + (int64_t)k * e + col), a);
        qs[i] = a;
    }

    // (64 slots) x (2E) = slot tile @ [Wk | Wv], register-tiled
    const int sg = tid / 32;                  // slots sg*8 .. sg*8 + 7
    const int cg = tid % 32;                  // columns cg*8 .. cg*8 + 7
    const bool active = cg * EA_T < e2;
    float acc[EA_T][EA_T];
#pragma unroll
    for (int i = 0; i < EA_T; ++i)
#pragma unroll
        for (int j = 0; j < EA_T; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < c; k0 += EA_KC) {
        const int kn = min(EA_KC, c - k0);
        __syncthreads();                      // tile written / chunk consumed
#pragma unroll 4
        for (int i = tid; i < EA_KC * e2; i += blockDim.x) {
            const int q = i / e2;
            const int col = i - q * e2;
            float w = 0.0f;
            if (q < kn) {
                const int64_t k = k0 + q;
                w = col < e ? wk[k * e + col] : wv[k * e + (col - e)];
            }
            wst[i] = w;
        }
        __syncthreads();
        if (active) {
            for (int q = 0; q < kn; ++q) {
                const float* ap = kvt + (k0 + q) * EA_LD + sg * EA_T;
                const float* bp = wst + q * e2 + cg * EA_T;
                const float4 a0 = *reinterpret_cast<const float4*>(ap);
                const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
                const float4 b0 = *reinterpret_cast<const float4*>(bp);
                const float4 b1 = *reinterpret_cast<const float4*>(bp + 4);
                const float a[EA_T] = {a0.x, a0.y, a0.z, a0.w,
                                       a1.x, a1.y, a1.z, a1.w};
                const float b[EA_T] = {b0.x, b0.y, b0.z, b0.w,
                                       b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < EA_T; ++i)
#pragma unroll
                    for (int j = 0; j < EA_T; ++j)
                        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
    }
    __syncthreads();                          // tile reads done: reuse as kvo
    if (active) {
#pragma unroll
        for (int i = 0; i < EA_T; ++i) {
            float* o = kvo + (sg * EA_T + i) * e2 + cg * EA_T;
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            *reinterpret_cast<float4*>(o + 4) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
    }
    __syncthreads();

    const int dh = e / n_heads;
    const float root = sqrtf((float)dh);
    for (int t = tid; t < br * n_heads * kk; t += blockDim.x) {
        const int r = t / (n_heads * kk);
        const int rem = t - r * n_heads * kk;
        const int h = rem / kk;
        const int j = rem - h * kk;
        const float* qv = qs + r * e + h * dh;
        const float* kv = kvo + (r * kk + j) * e2 + h * dh;
        float a = 0.0f;
        for (int q = 0; q < dh; ++q) a = fmaf(qv[q], kv[q], a);
        ps[t] = a / root;
    }
    __syncthreads();

    for (int t = tid; t < br * n_heads; t += blockDim.x) {
        const int r = t / n_heads;
        float* p = ps + t * kk;
        if (r >= nrows) continue;
        const uint8_t* ok = valid + (int64_t)(row0 + r) * kk;
        float mx = -INFINITY;
        bool any = false;
        for (int j = 0; j < kk; ++j) {
            if (ok[j]) { mx = fmaxf(mx, p[j]); any = true; }
        }
        float l = 0.0f;
        for (int j = 0; j < kk; ++j) {
            const float pj = ok[j] ? expf(p[j] - mx) : 0.0f;
            p[j] = pj;
            l += pj;
        }
        for (int j = 0; j < kk; ++j) p[j] = any ? p[j] / l : 0.0f;
    }
    __syncthreads();

    for (int i = tid; i < nrows * e; i += blockDim.x) {
        const int r = i / e;
        const int col = i - r * e;
        const float* p = ps + (r * n_heads + col / dh) * kk;
        const float* v = kvo + r * kk * e2 + e + col;
        float a = 0.0f;
        for (int j = 0; j < kk; ++j) a = fmaf(p[j], v[j * e2], a);
        out[(int64_t)(row0 + r) * e + col] = a;
    }
}

}  // namespace

extern "C" int repro_embed_attn(
        const void* h_self, int ds, const void* tab, int din,
        const void* idx, const void* dt, const void* valid, int r_total,
        int kk, const void* tw, const void* tb, int dtime, const void* wq,
        const void* wk, const void* wv, int e, int n_heads, void* out,
        void* stream) {
    if (r_total <= 0) return 0;
    if (kk < 1 || kk > EA_SLOTS || n_heads < 1 || e % n_heads != 0 ||
        e % 4 != 0 || e > EA_MAX_E)
        return (int)cudaErrorInvalidValue;
    const int br = EA_SLOTS / kk;
    const Layout lay(din + dtime, e, ds, br, n_heads, kk);
    const size_t smem = sizeof(float) * (size_t)lay.total;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            embed_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (r_total + br - 1) / br;
    embed_attn_kernel<<<blocks, EA_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h_self), ds,
        static_cast<const float*>(tab), din,
        static_cast<const int32_t*>(idx), static_cast<const float*>(dt),
        static_cast<const uint8_t*>(valid), r_total, kk,
        static_cast<const float*>(tw), static_cast<const float*>(tb), dtime,
        static_cast<const float*>(wq), static_cast<const float*>(wk),
        static_cast<const float*>(wv), e, n_heads, br,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}
