// embed_attn for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/embed_attn.py::_embed_attn_pallas (body
// _embed_attn_kernel). For each parent row r of the compacted frontier:
//   q      = h_self[r] @ Wq                                   (E)
//   kv_j   = [tab[idx[r, j]], cos(dt[r, j] * tw + tb)]   (c = Din + d_time)
//   k_j    = kv_j @ Wk,  v_j = kv_j @ Wv                      (E each)
//   per head h (width dh = E / H): s_j = q_h . k_j,h / sqrt(dh), masked
//   softmax over the valid slots (a row with no valid slot gives exactly 0),
//   out[r, h] = sum_j p_j v_j,h                               (R, E)
//
// The TPU kernel projects every slot's kv_j to K and V and carries an
// online softmax across a sequential grid axis over the slots. K and V are
// linear in kv_j, so this kernel folds the projections out of the slots:
//   a_h   = Wk_h q_h / sqrt(dh)          (c)   q folded into Wk
//   s_jh  = a_h . kv_j
//   g_h   = sum_j p_jh kv_j              (c)
//   out_h = g_h Wv_h                     (dh)
// the same function, with no (c x 2E) product per slot. A slot costs 2 H c
// multiply-adds and d_time cosines; the three per-row products
// (rows x ds x E, rows x dh x c and rows x c x dh a head) are GEMMs, run on
// the tensor cores at fp32 grade (three TF32 products a step, tf32x3.cuh).
//
// A block owns EA_ROWS parent rows. Its eight warps run each product as
// 16-row x 16-column tiles, the weights streaming through a three-stage
// cp.async ring (EA_KC deep, EA_NB wide, 16-byte copies where E and the
// head's offset allow), so each weight tile is staged once for the
// block's rows. Between the products, each warp walks the valid slots of
// its rows, SG at a time (4, or 2 where Din > 128; the gathers of a group
// are in flight together): a lane holds the kv elements lane + 32 i,
// gathered from tab and time-encoded in registers, one transposed warp
// reduction gives the group's scores for both heads, and the softmax is an
// online one over the groups, in slot order. Invalid slots are neither
// gathered nor encoded. Heads go two at a time, so the shared a / g tiles
// hold two heads whatever H is. Every sum runs in a fixed order with no
// atomics: the kernel is bitwise repeatable.
//
// Bound on this card: the per-row products (2 R E (ds + 2 c) FLOPs, three
// TF32 products each) and the per-slot scores, sums and time encodings,
// against the bytes of the rows and the gathered table rows. Timed on the
// H100, the products are held by the instructions around the mma.sync
// (fragment loads, operand splits) and by the L2 traffic of restaging the
// weights for every block; the slot phase by cosf and the gathers. The
// angle is one fmaf (one rounding, as jitted XLA forms it) and the cosine
// is cosf, not __cosf: dt * tw reaches 1e5, where the fast intrinsic is
// badly wrong, so the build never uses --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int EA_THREADS = 256;          // eight warps
constexpr int EA_WARPS = EA_THREADS / 32;
constexpr int EA_ROWS = 32;              // parent rows per block: 2 mma tiles
constexpr int EA_NB = 64;                // product columns per pass: 4 x 16
constexpr int EA_KC = 32;                // product depth per ring stage
constexpr int EA_STAGES = 3;
constexpr int EA_LDB = EA_NB + 8;        // 72: 8 mod 32 (k-major tiles)
constexpr int EA_LDN = EA_KC + 4;        // 36: 4 mod 8 (n-major tiles)
constexpr int EA_STAGE = EA_KC * EA_LDB; // = EA_NB * EA_LDN
constexpr int EA_MAX_K = 64;             // slots a row: two ballots
constexpr int EA_MAX_E = 128;
constexpr int EA_MAX_DIN = 256;          // 32 x the largest DPL
constexpr int EA_MAX_DTIME = 128;        // 32 x the largest TPL

// float offsets of the shared regions (host and device agree): the h_self
// tile, then the a / g tiles of two heads over it; q; the weight ring
struct Layout {
    int ld_h, ld_q, ld_c, q, ring, total;
    __host__ __device__ Layout(int ds, int e, int c) {
        ld_h = tf32_ld(ds);
        ld_q = tf32_ld(e);
        ld_c = tf32_ld(c);
        const int ag = 2 * EA_ROWS * ld_c;
        q = ag > EA_ROWS * ld_h ? ag : EA_ROWS * ld_h;
        ring = q + EA_ROWS * ld_q;
        total = ring + EA_STAGES * EA_STAGE;
    }
};

// C (EA_ROWS x n) = A (EA_ROWS x kd, shared, row stride lda) @ B, with
// B(k, j) = b[k * bsk + j] (KMAJOR) or b[k + j * bsn] in device memory,
// staged as it lies: a k-major tile (row stride EA_LDB) or an n-major one
// (EA_LDN), by 16-byte copies where the stride and b are aligned. Column
// passes of EA_NB, each over depth chunks of EA_KC through the ring; warp
// w owns rows (w % 2) * 16 and columns (w / 2) * 16 of a pass.
// epi(row, col, value) receives every entry with col < n. Ends with a
// barrier: the ring is free and epi's shared writes are visible.
template <bool KMAJOR, class Epi>
__device__ __forceinline__ void block_product(
        const float* as, int lda, int kd, const float* __restrict__ b,
        int64_t stride, int n, float* ring, Epi epi) {
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int rt = warp & 1, cg = warp >> 1;
    const int nkc = (kd + EA_KC - 1) / EA_KC;
    const int total = nkc * ((n + EA_NB - 1) / EA_NB);
    const bool vec = stride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    auto issue = [&](int s) {
        float* bs = ring + (s % EA_STAGES) * EA_STAGE;
        const int k0 = (s % nkc) * EA_KC, n0 = (s / nkc) * EA_NB;
        // (kk, jj) of copy e, contiguous along jj (KMAJOR) or kk
        if (vec) {
            for (int e = tid; e < EA_KC * EA_NB / 4; e += EA_THREADS) {
                const int kk =
                    KMAJOR ? e / (EA_NB / 4) : 4 * (e % (EA_KC / 4));
                const int jj =
                    KMAJOR ? 4 * (e % (EA_NB / 4)) : e / (EA_KC / 4);
                const int live = KMAJOR
                    ? (k0 + kk < kd ? min(4, max(0, n - n0 - jj)) : 0)
                    : (n0 + jj < n ? min(4, max(0, kd - k0 - kk)) : 0);
                const int64_t off = KMAJOR ? (k0 + kk) * stride + n0 + jj
                                           : k0 + kk + (n0 + jj) * stride;
                cp_async16(KMAJOR ? bs + kk * EA_LDB + jj
                                  : bs + jj * EA_LDN + kk,
                           b + off, 4 * live, b);
            }
        } else {
            for (int e = tid; e < EA_KC * EA_NB; e += EA_THREADS) {
                const int kk = KMAJOR ? e / EA_NB : e % EA_KC;
                const int jj = KMAJOR ? e % EA_NB : e / EA_KC;
                const int64_t off = KMAJOR ? (k0 + kk) * stride + n0 + jj
                                           : k0 + kk + (n0 + jj) * stride;
                cp_async4(KMAJOR ? bs + kk * EA_LDB + jj
                                 : bs + jj * EA_LDN + kk,
                          b + off, k0 + kk < kd && n0 + jj < n, b);
            }
        }
    };
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < EA_STAGES - 1; ++s) {
        if (s < total) issue(s);
        cp_async_commit();
    }
    for (int s = 0; s < total; ++s) {
        cp_async_wait<EA_STAGES - 2>();
        __syncthreads();   // stage s landed; slot (s - 1) % 3 is free
        if (s + EA_STAGES - 1 < total) issue(s + EA_STAGES - 1);
        cp_async_commit();
        const float* bs = ring + (s % EA_STAGES) * EA_STAGE;
        const int k0 = (s % nkc) * EA_KC;
        auto step = [&](int ks, auto mask) {
            const FragA fa = load_frag_a<decltype(mask)::value>(
                as, lda, rt * 16, k0 + ks, kd);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int col = cg * 16 + nt * 8;
                mma_3xtf32(acc[nt], fa,
                           KMAJOR ? load_frag_b(bs, EA_LDB, ks, col)
                                  : load_frag_b_nmajor(bs, EA_LDN, ks, col));
            }
        };
        if (k0 + EA_KC <= kd) {   // a whole chunk: straight-line, no masks
#pragma unroll
            for (int ks = 0; ks < EA_KC; ks += 8)
                step(ks, std::false_type());
        } else {
            for (int ks = 0; k0 + ks < kd; ks += 8)
                step(ks, std::true_type());
        }
        if (s % nkc == nkc - 1) {
            const int n0 = (s / nkc) * EA_NB;
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int col = n0 + cg * 16 + nt * 8 + 2 * t + (i & 1);
                    if (col < n) epi(rt * 16 + g + (i >> 1) * 8, col,
                                     acc[nt][i]);
                    acc[nt][i] = 0.0f;
                }
        }
    }
    __syncthreads();
}

// v[i] <- its sum over the warp's 32 lanes, for each i < N (4 or 8), in a
// fixed order: halving steps at lane offsets 16, 8 (and 4), each lane
// keeping half the values and adding its partner's, leave lane L with a
// partial of one value; a butterfly over the remaining offsets completes
// it, and a broadcast from the lane that holds each total ends it
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
    static_assert(N == 4 || N == 8, "four or eight sums");
    constexpr unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    float w[N];
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = v[i];
    int o = 16;
#pragma unroll
    for (int n = N; n > 1; n >>= 1, o >>= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
            const float keep = up ? w[i + n / 2] : w[i];
            const float give = up ? w[i] : w[i + n / 2];
            w[i] = keep + __shfl_xor_sync(full, give, o);
        }
    }
#pragma unroll
    for (; o > 0; o >>= 1) w[0] += __shfl_xor_sync(full, w[0], o);
    // value i's total sits in the lanes whose high bits spell i
    constexpr int shift = N == 8 ? 2 : 3;
#pragma unroll
    for (int i = 0; i < N; ++i)
        v[i] = __shfl_sync(full, w[0], i << shift);
}

// The slots of heads h0 and h0 + 1 (nh of them, 1 or 2) for the block's
// rows: reads a_h (row-major in ag, head b at b * EA_ROWS * ld_c, the tab
// part at columns [0, din), the time part at [din, din + dtime)) and
// writes g_h over it. Lane L holds kv elements L + 32 i: DPL of the tab
// part, TPL of the time part.
template <int DPL, int TPL, int SG>
__device__ __forceinline__ void slot_phase(
        float* ag, int ld_c, int nh, const float* __restrict__ tab, int din,
        const int32_t* __restrict__ idx, const float* __restrict__ dt,
        const uint8_t* __restrict__ valid, int kk,
        const float* __restrict__ tw, const float* __restrict__ tb,
        int dtime, int row0, int nrows) {
    constexpr int P = DPL + TPL;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float twr[TPL], tbr[TPL];
#pragma unroll
    for (int u = 0; u < TPL; ++u) {
        const int q = lane + 32 * u;
        twr[u] = q < dtime ? tw[q] : 0.0f;
        tbr[u] = q < dtime ? tb[q] : 0.0f;
    }
    for (int r = warp; r < nrows; r += EA_WARPS) {
        // slot j lives in lane j % 32 of half j / 32
        const int64_t base = (int64_t)(row0 + r) * kk;
        int id[2] = {0, 0};
        float dj[2] = {0.0f, 0.0f};
        bool ok[2] = {false, false};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = lane + 32 * half;
            if (j < kk && valid[base + j]) {
                ok[half] = true;
                id[half] = idx[base + j];
                dj[half] = dt[base + j];
            }
        }
        uint64_t live = (uint64_t)__ballot_sync(0xffffffffu, ok[0]) |
                        ((uint64_t)__ballot_sync(0xffffffffu, ok[1]) << 32);
        float a[2][P], gs[2][P], m[2], l[2];
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
            const float* ar = ag + hb * EA_ROWS * ld_c + r * ld_c;
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                const int col = lane + 32 * i;
                a[hb][i] = hb < nh && col < din ? ar[col] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < TPL; ++u) {
                const int q = lane + 32 * u;
                a[hb][DPL + u] = hb < nh && q < dtime ? ar[din + q] : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < P; ++i) gs[hb][i] = 0.0f;
            m[hb] = -INFINITY;
            l[hb] = 0.0f;
        }
        while (live) {
            int js[SG];
#pragma unroll
            for (int s = 0; s < SG; ++s) {
                js[s] = live ? __ffsll((long long)live) - 1 : -1;
                live &= live - 1;
            }
            float kv[SG][P];
#pragma unroll
            for (int s = 0; s < SG; ++s) {
                const int j = js[s] < 0 ? 0 : js[s];
                const int lo = __shfl_sync(0xffffffffu, id[0], j & 31);
                const int hi = __shfl_sync(0xffffffffu, id[1], j & 31);
                const float t0 = __shfl_sync(0xffffffffu, dj[0], j & 31);
                const float t1 = __shfl_sync(0xffffffffu, dj[1], j & 31);
                const float* row = tab + (int64_t)(j < 32 ? lo : hi) * din;
                const float dts = j < 32 ? t0 : t1;
#pragma unroll
                for (int i = 0; i < DPL; ++i) {
                    const int col = lane + 32 * i;
                    kv[s][i] = js[s] >= 0 && col < din ? __ldg(row + col)
                                                       : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < TPL; ++u) {
                    const int q = lane + 32 * u;
                    kv[s][DPL + u] = js[s] >= 0 && q < dtime
                        ? cosf(fmaf(dts, twr[u], tbr[u])) : 0.0f;
                }
            }
            // the scores of the group's slots for both heads (a_h is
            // already divided by sqrt(dh))
            float dots[2 * SG];
#pragma unroll
            for (int s = 0; s < SG; ++s)
#pragma unroll
                for (int hb = 0; hb < 2; ++hb) {
                    float p = 0.0f;
#pragma unroll
                    for (int i = 0; i < P; ++i)
                        p = fmaf(a[hb][i], kv[s][i], p);
                    dots[2 * s + hb] = p;
                }
            warp_sums(dots);
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
                if (hb >= nh) break;
                float sc[SG];
                float mx = m[hb];
#pragma unroll
                for (int s = 0; s < SG; ++s) {
                    sc[s] = dots[2 * s + hb];
                    if (js[s] >= 0) mx = fmaxf(mx, sc[s]);
                }
                const float alpha = expf(m[hb] - mx);   // 0 on the first group
                float lsum = l[hb] * alpha;
#pragma unroll
                for (int s = 0; s < SG; ++s) {
                    sc[s] = js[s] >= 0 ? expf(sc[s] - mx) : 0.0f;
                    lsum += sc[s];
                }
#pragma unroll
                for (int i = 0; i < P; ++i) {
                    float v = gs[hb][i] * alpha;
#pragma unroll
                    for (int s = 0; s < SG; ++s) v = fmaf(sc[s], kv[s][i], v);
                    gs[hb][i] = v;
                }
                m[hb] = mx;
                l[hb] = lsum;
            }
        }
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
            if (hb >= nh) break;
            float* gr = ag + hb * EA_ROWS * ld_c + r * ld_c;
            const bool any = l[hb] > 0.0f;
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
                const int col = lane + 32 * i;
                if (col < din) gr[col] = any ? gs[hb][i] / l[hb] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < TPL; ++u) {
                const int q = lane + 32 * u;
                if (q < dtime) gr[din + q] = any ? gs[hb][DPL + u] / l[hb]
                                                 : 0.0f;
            }
        }
    }
}

template <int DPL, int TPL, int SG>
__global__ void __launch_bounds__(EA_THREADS, 2) embed_attn_kernel(
        const float* __restrict__ h_self, int ds,
        const float* __restrict__ tab, int din,
        const int32_t* __restrict__ idx, const float* __restrict__ dt,
        const uint8_t* __restrict__ valid, int r_total, int kk,
        const float* __restrict__ tw, const float* __restrict__ tb,
        int dtime,
        const float* __restrict__ wq, const float* __restrict__ wk,
        const float* __restrict__ wv, int e, int n_heads,
        float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    const int c = din + dtime;
    const Layout lay(ds, e, c);
    float* hs = smem;                  // EA_ROWS x ds, until q is formed
    float* ag = smem;                  // then a / g of two heads
    float* qs = smem + lay.q;          // EA_ROWS x E
    float* ring = smem + lay.ring;
    const int row0 = blockIdx.x * EA_ROWS;
    const int nrows = min(EA_ROWS, r_total - row0);

    for (int i = threadIdx.x; i < EA_ROWS * ds; i += EA_THREADS) {
        const int r = i / ds, k = i - r * ds;
        hs[r * lay.ld_h + k] =
            r < nrows ? h_self[(int64_t)(row0 + r) * ds + k] : 0.0f;
    }
    __syncthreads();
    block_product<true>(hs, lay.ld_h, ds, wq, e, e, ring,
                        [&](int r, int col, float v) {
                            qs[r * lay.ld_q + col] = v;
                        });

    const int dh = e / n_heads;
    const float root = sqrtf((float)dh);
    for (int h0 = 0; h0 < n_heads; h0 += 2) {
        const int nh = min(2, n_heads - h0);
        for (int hb = 0; hb < nh; ++hb) {
            float* at = ag + hb * EA_ROWS * lay.ld_c;
            // a_h = q_h Wk_h^T / sqrt(dh): B(k, i) = Wk[i, h dh + k]
            block_product<false>(qs + (h0 + hb) * dh, lay.ld_q, dh,
                                 wk + (h0 + hb) * dh, e, c, ring,
                                 [&](int r, int col, float v) {
                                     at[r * lay.ld_c + col] = v / root;
                                 });
        }
        slot_phase<DPL, TPL, SG>(ag, lay.ld_c, nh, tab, din, idx, dt, valid,
                                 kk, tw, tb, dtime, row0, nrows);
        __syncthreads();
        for (int hb = 0; hb < nh; ++hb) {
            float* o = out + (int64_t)row0 * e + (h0 + hb) * dh;
            // out_h = g_h Wv_h: B(i, k) = Wv[i, h dh + k]
            block_product<true>(ag + hb * EA_ROWS * lay.ld_c, lay.ld_c, c,
                                wv + (h0 + hb) * dh, e, dh, ring,
                                [&](int r, int col, float v) {
                                    if (r < nrows)
                                        o[(int64_t)r * e + col] = v;
                                });
        }
    }
}

// per-lane register widths: DPL covers Din <= 32 DPL, TPL d_time <= 32 TPL
// (TPL <= DPL; DPL 8 takes two slots a group to stay within registers)
template <int DPL, int TPL>
constexpr auto kernel_for() {
    return &embed_attn_kernel<DPL, TPL, DPL >= 8 ? 2 : 4>;
}

using Kernel = decltype(kernel_for<1, 1>());

Kernel pick(int din, int dtime) {
    const int dn = (din + 31) / 32, tn = (dtime + 31) / 32;
    const int tpl = tn <= 1 ? 1 : tn <= 2 ? 2 : 4;
    int dpl = dn <= 1 ? 1 : dn <= 4 ? 4 : 8;
    if (dpl < tpl) dpl = 4;
    switch (dpl * 8 + tpl) {
        case 1 * 8 + 1: return kernel_for<1, 1>();
        case 4 * 8 + 1: return kernel_for<4, 1>();
        case 4 * 8 + 2: return kernel_for<4, 2>();
        case 4 * 8 + 4: return kernel_for<4, 4>();
        case 8 * 8 + 1: return kernel_for<8, 1>();
        case 8 * 8 + 2: return kernel_for<8, 2>();
        default: return kernel_for<8, 4>();
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
    if (kk < 1 || kk > EA_MAX_K || n_heads < 1 || e % n_heads != 0 ||
        e > EA_MAX_E || ds < 1 || din < 1 || din > EA_MAX_DIN ||
        dtime < 0 || dtime > EA_MAX_DTIME)
        return (int)cudaErrorInvalidValue;
    const Layout lay(ds, e, din + dtime);
    const size_t smem = sizeof(float) * (size_t)lay.total;
    const Kernel kernel = pick(din, dtime);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (r_total + EA_ROWS - 1) / EA_ROWS;
    kernel<<<blocks, EA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h_self), ds,
        static_cast<const float*>(tab), din,
        static_cast<const int32_t*>(idx), static_cast<const float*>(dt),
        static_cast<const uint8_t*>(valid), r_total, kk,
        static_cast<const float*>(tw), static_cast<const float*>(tb), dtime,
        static_cast<const float*>(wq), static_cast<const float*>(wk),
        static_cast<const float*>(wv), e, n_heads,
        static_cast<float*>(out));
    return (int)cudaGetLastError();
}

