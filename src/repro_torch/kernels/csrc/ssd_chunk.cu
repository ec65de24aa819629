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
// widths (G = 8, L = 256, N = 256, P = 257) the score block alone is
// 256 KB, more than a block's shared memory, and a block a group would
// leave 124 of the 132 SMs idle. Here all four products run on the tensor
// cores at fp32 grade (three TF32 mma.sync products a step, tf32x3.cuh),
// over blocks of two kinds:
//  - a y block owns SSD_BM query rows and a slab of P columns. It first
//    takes the carry-in (q * exp(lcum)) h0 into its accumulators (the rows
//    of h0 streamed in SSD_KC-deep chunks), then walks the key tiles j0 <=
//    its last row flash-style: the SSD_BM x SSD_BK score tile forms in
//    registers (q resident in shared memory, k streamed SSD_KS deep over
//    N), is decayed and masked in fp32 (exactly 0 above the diagonal),
//    restaged through shared memory as the A operand, and multiplied into
//    the same accumulators by the key tile's rows of v;
//  - an h1 block owns SSD_BM rows of N and a slab of P columns, and walks
//    L in SSD_BK-deep chunks of k (read transposed: (k * w)^T is its A
//    operand) and v, then adds exp(ltot) h0.
// A block's eight warps are two halves of 2 x 2: each half takes the same
// 16-row x SSD_NT-tile warp tiles over alternate halves of every depth
// chunk, and half 1 hands its sums to half 0 (the scores once a key tile,
// the accumulators at the end), which adds them, its own first. P is cut
// into the fewest slabs of at most 2 SSD_NT 8-column tiles, of equal tile
// counts (P = 257: 33 tiles, two slabs of 17 and 16); a warp always runs
// its SSD_NT tiles, and the sums of columns past the slab or past P are
// never stored. Every operand reaches shared memory through a three-stage
// cp.async ring of 16-byte copies where q and k allow (N % 4 == 0), and
// always for v and h0: each row is copied from the 16-byte boundary at or
// before the slab's first column and read back shifted (P = 257 leaves no
// row aligned, and with L P or N P odd no group's base is either); fixed
// tile widths, so no staging loop divides by a runtime
// width. Every product is rounded as the plain version's before it is
// split: the score, then its decay; q * exp(lcum); k * exp(ltot - lcum);
// the sums run in another order. exp is expf (no --use_fast_math).
//
// Balance and fill: at G = 8, P = 257 there are 128 y blocks and 128 h1
// blocks of 256 threads, two resident a multiprocessor (112 KB of shared
// memory and at most 128 registers a thread each). A y block of row tile
// i walks i + 1 key tiles, so the y blocks launch first, heaviest tile
// first, then the h1 blocks (as costly as the lightest y block's
// carry-in). The last y row tile is the critical path: timed on the H100,
// its time goes about equally to the products, the copies' instructions
// and the score tiles (each computed once a slab).
//
// Bound on this card: about 101 MFLOP of products a group at the xLSTM
// widths (the score triangle, S v, the carry-in, the state update), as
// three TF32 products each at the 495 TFLOP/s TF32 peak, plus the
// decays and scalings at the fp32 peak: about 0.005 ms a launch at G = 8,
// against 12.6 MB moved (0.0038 ms).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int SSD_THREADS = 256;   // 2 depth halves x 2 x 2 warps
constexpr int SSD_BM = 32;         // rows a block owns (of y, or of h1)
constexpr int SSD_BK = 32;         // keys a tile; depth of a v or h1 chunk
constexpr int SSD_KS = 128;        // depth over N of a score chunk
constexpr int SSD_KC = 32;         // depth over N of a carry-in chunk
constexpr int SSD_NT = 9;          // 8-column tiles a warp holds
constexpr int SSD_SLAB = 2 * 8 * SSD_NT;   // 144 columns of P a block
// v / h0 rows: the slab, shifted by up to 3 to a 16-byte boundary (152:
// 24 mod 32, conflict-free k-major B)
constexpr int SSD_LDV = SSD_SLAB + 8;
constexpr int SSD_LDK = SSD_KS + 4;        // 132, 4 mod 8: n-major B
constexpr int SSD_LDS = SSD_BK + 4;        // 36, 4 mod 8: the scores (A)
constexpr int SSD_LDT = SSD_BM + 8;        // 40, 8 mod 32: k read as A^T
constexpr int SSD_STAGES = 3;
// a ring stage: [k chunk of an h1 step, BK x LDT] [v or h0 chunk, BK x
// LDV] [BK floats: lcum of the keys (y) or their weights (h1)] [BK row
// shifts]; a y score chunk (BK x LDK) reuses the first two areas
constexpr int SSD_VOFF = SSD_BK * SSD_LDT;
constexpr int SSD_XOFF = SSD_VOFF + SSD_BK * SSD_LDV;
constexpr int SSD_SOFF = SSD_XOFF + SSD_BK;
constexpr int SSD_STAGE = SSD_SOFF + SSD_BK;
constexpr int SSD_MAX_N = 256;
constexpr int SSD_MAX_P = 512;

static_assert(SSD_KC == SSD_BK, "an h0 chunk fills the v area");
static_assert(SSD_BK * SSD_LDK <= SSD_XOFF, "score chunk");
static_assert(SSD_BM * SSD_LDS <= SSD_VOFF, "partial scores in the k area");
static_assert(4 * SSD_NT * 4 * 32 <= SSD_STAGES * SSD_STAGE, "hand-off");

// the launch's shape, from the host
struct SsdShape {
    int g, l, n, p;
    int ldq;          // row stride of the resident q tile: N up to KS, + 4
    int ns;           // P slabs
    int slab_tiles;   // 8-column tiles a slab (the last may hold fewer)
    int rt;           // y row tiles: ceil(L / BM)
};

// rows r0 .. r0 + NR - 1, columns c0 .. c0 + NC - 1 (those below ncl) of
// a row-major (rows x cols) matrix into dst (row stride ld), zero outside
// the matrix, by 16-byte copies: cols, c0 and ncl multiples of 4, src
// 16-byte aligned
template <int NR, int NC>
__device__ __forceinline__ void stage16(float* dst, int ld,
                                        const float* __restrict__ src,
                                        int rows, int cols, int r0, int c0,
                                        int ncl) {
    for (int e = threadIdx.x; e < NR * NC / 4; e += SSD_THREADS) {
        const int r = e / (NC / 4), c = 4 * (e % (NC / 4));
        if (c >= ncl) continue;
        const int live = r0 + r < rows ? min(4, max(0, cols - c0 - c)) : 0;
        cp_async16(dst + r * ld + c, src + (int64_t)(r0 + r) * cols + c0 + c,
                   4 * live, src);
    }
}

// the same by 4-byte copies (any cols and c0): rows outer, each thread's
// columns fixed, only columns below ncl
template <int NR, int NC>
__device__ __forceinline__ void stage4(float* dst, int ld,
                                       const float* __restrict__ src,
                                       int rows, int cols, int r0, int c0,
                                       int ncl) {
#pragma unroll
    for (int c = threadIdx.x; c < NC; c += SSD_THREADS) {
        if (c >= ncl) break;
        const bool col_ok = c0 + c < cols;
        const float* s = src + (int64_t)r0 * cols + c0 + c;
#pragma unroll 4
        for (int r = 0; r < NR; ++r)
            cp_async4(dst + r * ld + c, s + (int64_t)r * cols,
                      col_ok && r0 + r < rows, src);
    }
}

// rows r0.. (NR of them), columns c0 .. c0 + ncl - 1 of a row-major (rows x
// cols) matrix, any cols and c0, by 16-byte copies from each row's 16-byte
// boundary at or before column c0 (a boundary of the address: src, a
// group's slice, need not be aligned itself): row r lands shifted right by
// sh[r] (0 to 3; VEC false: 4-byte copies, no shift). Columns past cols and
// rows past rows are zero; the shifted-in words before c0 lie inside the
// tensor, whose base is 16-byte aligned (VEC) while c0 is a multiple of 8,
// so a shift that reaches back past column 0 reads the previous row or
// group. ld >= ncl + 4 rounded up to 4
template <int NR, int NC, bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int* sh,
                                           const float* __restrict__ src,
                                           int rows, int cols, int r0,
                                           int c0, int ncl) {
    if (!VEC) {
        if (threadIdx.x < NR) sh[threadIdx.x] = 0;
        stage4<NR, NC>(dst, ld, src, rows, cols, r0, c0, ncl);
        return;
    }
    // a warp a row at a time, a lane a 16-byte quad (W of them at most)
    constexpr int W = NC / 4 + 1;
    constexpr int WARPS = SSD_THREADS / 32;
    const int lane = threadIdx.x & 31;
    // an aligned address inside the tensor, named by the copies of no bytes
    const float* any =
        src - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    for (int r = threadIdx.x >> 5; r < NR; r += WARPS) {
        const int64_t at = (int64_t)(r0 + r) * cols + c0;
        const int shift =
            (int)((reinterpret_cast<uintptr_t>(src + at) >> 2) & 3);
        if (lane == 0) sh[r] = shift;
        const bool row_ok = r0 + r < rows;
        const float* s = src + at - shift;
        float* d = dst + r * ld;
#pragma unroll
        for (int m = lane; m < W; m += 32) {
            if (4 * m >= ncl + shift) break;
            const int c = c0 - shift + 4 * m;   // column of the quad's first
            const int live = row_ok ? min(4, cols - c) : 0;
            cp_async16(d + 4 * m, s + 4 * m, 4 * max(live, 0), any);
        }
    }
}

// A fragment of rows r0.., depth k0.. of a row-major tile, each element
// times its row's scale (rounded in fp32, then split)
__device__ __forceinline__ FragA load_frag_a_scaled(const float* as, int lda,
                                                    int r0, int k0, float s0,
                                                    float s8) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = as + (r0 + g) * lda + k0 + t;
    return frag_a(__fmul_rn(p[0], s0), __fmul_rn(p[8 * lda], s8),
                        __fmul_rn(p[4], s0), __fmul_rn(p[8 * lda + 4], s8));
}

// A fragment of A = (K * w)^T from a k-major tile kt[j][n] (row stride
// ldt): rows n0.., depth j0.., element (n, j) = kt[j][n] * w[j]
__device__ __forceinline__ FragA load_frag_a_kw(const float* kt, int ldt,
                                                const float* w, int n0,
                                                int j0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = kt + (j0 + t) * ldt + n0 + g;
    const float w0 = w[j0 + t], w4 = w[j0 + t + 4];
    return frag_a(__fmul_rn(p[0], w0), __fmul_rn(p[8], w0),
                        __fmul_rn(p[4 * ldt], w4),
                        __fmul_rn(p[4 * ldt + 8], w4));
}

// acc[t] += A (16 x 8 at depth ks) times the warp's SSD_NT tiles of a
// shifted v / h0 chunk (rows ks.., the warp's columns from col)
__device__ __forceinline__ void mma_rows(float (&acc)[SSD_NT][4],
                                         const FragA& fa, const float* vb,
                                         const int* sh, int ks, int col) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* b0 = vb + (ks + t) * SSD_LDV + sh[ks + t] + col + g;
    const float* b4 = vb + (ks + t + 4) * SSD_LDV + sh[ks + t + 4] + col + g;
#pragma unroll
    for (int i = 0; i < SSD_NT; ++i)
        mma_3xtf32(acc[i], fa, frag_b(b0[8 * i], b4[8 * i]));
}

// VQK: q and k by 16-byte copies (N % 4 == 0, aligned); VVH: v and h0 by
// shifted 16-byte copies (aligned)
template <bool VQK, bool VVH>
__global__ void __launch_bounds__(SSD_THREADS, 2) ssd_chunk_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ lcum,
        const float* __restrict__ h0, SsdShape sh,
        float* __restrict__ y, float* __restrict__ h1) {
    extern __shared__ __align__(16) float smem[];
    float* ring = smem;                               // STAGES x STAGE
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int half = warp >> 2;                       // depth half
    const int w4 = warp & 3;
    const int wr = w4 & 1, wc = w4 >> 1;              // row warp, column warp
    const int gq = lane >> 2, tq = lane & 3;

    // block -> (kind, row tile, group, slab): y tiles first, heaviest first
    const int64_t per_tile = (int64_t)sh.g * sh.ns;
    int64_t bid = blockIdx.x;
    const bool is_y = bid < sh.rt * per_tile;
    if (!is_y) bid -= sh.rt * per_tile;
    const int tile = is_y ? sh.rt - 1 - (int)(bid / per_tile)
                          : (int)(bid / per_tile);
    const int64_t grp = (bid % per_tile) / sh.ns;
    const int slab = (int)(bid % per_tile % sh.ns);
    const int ptiles = (sh.p + 7) / 8;
    const int t0 = slab * sh.slab_tiles;
    const int pb = 8 * t0;                            // the slab's first column
    const int sw = 8 * min(sh.slab_tiles, ptiles - t0);   // and its width
    const int colw = wc * 8 * SSD_NT;                 // the warp's first column

    const int l_len = sh.l, n_dim = sh.n, p_dim = sh.p;
    const float* qg = q + grp * l_len * (int64_t)n_dim;
    const float* kg = k + grp * l_len * (int64_t)n_dim;
    const float* vg = v + grp * l_len * (int64_t)p_dim;
    const float* lg = lcum + grp * (int64_t)l_len;
    const float* hg = h0 + grp * n_dim * (int64_t)p_dim;
    const int r0 = tile * SSD_BM;     // the block's first row (of y or h1)
    const int rw = wr * 16;           // the warp's first row in the tile

    float acc[SSD_NT][4];
#pragma unroll
    for (int t = 0; t < SSD_NT; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0.0f;

    // half 1 hands its sums to half 0 through the ring, which adds them
    // (its own first) and stores them. The columns past the slab (a warp's
    // tiles past sw) hold whatever the ring held: their sums are never
    // stored
    auto store = [&](float* out, int n_rows, int64_t row_base, int row0,
                     auto value) {
        cp_async_wait<0>();
        __syncthreads();
        float* red = ring + w4 * (SSD_NT * 4 * 32) + lane;
        if (half) {
#pragma unroll
            for (int t = 0; t < SSD_NT; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) red[(t * 4 + i) * 32] = acc[t][i];
        }
        __syncthreads();
        if (half) return;
#pragma unroll
        for (int t = 0; t < SSD_NT; ++t)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int row = row0 + rw + gq + (i >> 1) * 8;
                const int cs = colw + 8 * t + 2 * tq + (i & 1);
                const int col = pb + cs;
                if (row < n_rows && cs < sw && col < p_dim) {
                    const int64_t o = (row_base + row) * p_dim + col;
                    out[o] = value(row, col,
                                   acc[t][i] + red[(t * 4 + i) * 32]);
                }
            }
    };

    if (is_y) {
        float* qs = ring + SSD_STAGES * SSD_STAGE;    // BM x ldq
        float* st = qs + SSD_BM * sh.ldq;             // scores, BM x LDS
        float* lrow = st + SSD_BM * SSD_LDS;          // lcum of the rows
        float* erow = lrow + SSD_BM;                  // exp(lcum) of the rows
        const int i_last = min(r0 + SSD_BM, l_len) - 1;
        const int nkt = i_last / SSD_BK + 1;          // key tiles j0 <= i_last
        const int nc = (n_dim + SSD_KC - 1) / SSD_KC; // carry-in steps
        const int nsc = (n_dim + SSD_KS - 1) / SSD_KS;  // score steps a tile
        const int steps = nc + nkt * (nsc + 1);

        if (tid < SSD_BM) {
            const int i = r0 + tid;
            const float li = i < l_len ? lg[i] : 0.0f;
            lrow[tid] = li;
            erow[tid] = i < l_len ? expf(li) : 0.0f;
        }
        // the q tile, resident: rows r0.., columns 0 .. ldq - 5
        if (VQK)
            stage16<SSD_BM, SSD_MAX_N>(qs, sh.ldq, qg, l_len, n_dim, r0, 0,
                                       sh.ldq - 4);
        else
            stage4<SSD_BM, SSD_MAX_N>(qs, sh.ldq, qg, l_len, n_dim, r0, 0,
                                      sh.ldq - 4);
        auto issue = [&](int c) {
            float* sb = ring + (c % SSD_STAGES) * SSD_STAGE;
            int* shv = reinterpret_cast<int*>(sb + SSD_SOFF);
            if (c < nc) {   // rows c KC.. of h0, the slab's columns
                stage_rows<SSD_KC, SSD_SLAB, VVH>(sb + SSD_VOFF, SSD_LDV,
                                                  shv, hg, n_dim, p_dim,
                                                  c * SSD_KC, pb, sw);
                return;
            }
            const int kt = (c - nc) / (nsc + 1), sub = (c - nc) % (nsc + 1);
            const int j0 = kt * SSD_BK;
            if (sub < nsc) {   // keys j0.., columns sub KS.. of k
                if (VQK)
                    stage16<SSD_BK, SSD_KS>(sb, SSD_LDK, kg, l_len, n_dim, j0,
                                            sub * SSD_KS, SSD_KS);
                else
                    stage4<SSD_BK, SSD_KS>(sb, SSD_LDK, kg, l_len, n_dim, j0,
                                           sub * SSD_KS, SSD_KS);
            } else {           // rows j0.. of v and their lcum
                stage_rows<SSD_BK, SSD_SLAB, VVH>(sb + SSD_VOFF, SSD_LDV,
                                                  shv, vg, l_len, p_dim, j0,
                                                  pb, sw);
                if (tid < SSD_BK)
                    sb[SSD_XOFF + tid] = j0 + tid < l_len ? lg[j0 + tid]
                                                          : 0.0f;
            }
        };

        float sacc[2][4] = {};
        for (int s = 0; s < SSD_STAGES - 1; ++s) {
            if (s < steps) issue(s);
            cp_async_commit();
        }
        for (int c = 0; c < steps; ++c) {
            cp_async_wait<SSD_STAGES - 2>();
            __syncthreads();   // step c landed; slot (c - 1) % 3 is free
            if (c + SSD_STAGES - 1 < steps) issue(c + SSD_STAGES - 1);
            cp_async_commit();
            const float* sb = ring + (c % SSD_STAGES) * SSD_STAGE;
            const int* shv = reinterpret_cast<const int*>(sb + SSD_SOFF);
            if (c < nc) {
                // carry-in: (q * exp(lcum)) h0 over this half of depth
                // c KC..
                const float s0 = erow[rw + gq], s8 = erow[rw + gq + 8];
#pragma unroll
                for (int kk = 0; kk < SSD_KC / 2; kk += 8) {
                    const int ks = half * (SSD_KC / 2) + kk;
                    mma_rows(acc, load_frag_a_scaled(qs, sh.ldq, rw,
                                                     c * SSD_KC + ks, s0, s8),
                             sb + SSD_VOFF, shv, ks, colw);
                }
                continue;
            }
            const int kt = (c - nc) / (nsc + 1), sub = (c - nc) % (nsc + 1);
            if (sub < nsc) {
                // the score tile: rows rw.., keys wc 16.., over this half
                // of depth sub KS..
                if (sub == 0) {
#pragma unroll
                    for (int t = 0; t < 2; ++t)
#pragma unroll
                        for (int i = 0; i < 4; ++i) sacc[t][i] = 0.0f;
                }
#pragma unroll
                for (int kk = 0; kk < SSD_KS / 2; kk += 8) {
                    const int ks = half * (SSD_KS / 2) + kk;
                    const FragA fa = load_frag_a<false>(
                        qs, sh.ldq, rw, sub * SSD_KS + ks, 0);
#pragma unroll
                    for (int t = 0; t < 2; ++t)
                        mma_3xtf32(sacc[t], fa, load_frag_b_nmajor(
                            sb, SSD_LDK, ks, wc * 16 + 8 * t));
                }
                continue;
            }
            // half 1 hands its partial scores to half 0 (in this stage's
            // k area, free in a v step), which adds them (its own first),
            // decays and masks them in fp32 and restages them as A
            const int j0 = kt * SSD_BK;
            const float* lk = sb + SSD_XOFF;
            float* part = ring + (c % SSD_STAGES) * SSD_STAGE;
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int r = rw + gq + (i >> 1) * 8;
                    const int jj = wc * 16 + 8 * t + 2 * tq + (i & 1);
                    if (half) part[r * SSD_LDS + jj] = sacc[t][i];
                }
            __syncthreads();
            if (!half) {
#pragma unroll
                for (int t = 0; t < 2; ++t)
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int r = rw + gq + (i >> 1) * 8;
                        const int jj = wc * 16 + 8 * t + 2 * tq + (i & 1);
                        const int row = r0 + r;
                        const bool keep = j0 + jj <= row && row < l_len;
                        const float s_ = sacc[t][i] + part[r * SSD_LDS + jj];
                        st[r * SSD_LDS + jj] = keep
                            ? __fmul_rn(s_, expf(__fsub_rn(lrow[r], lk[jj])))
                            : 0.0f;
                    }
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < SSD_BK / 2; kk += 8) {
                const int ks = half * (SSD_BK / 2) + kk;
                mma_rows(acc, load_frag_a<false>(st, SSD_LDS, rw, ks, 0),
                         sb + SSD_VOFF, shv, ks, colw);
            }
        }
        store(y, l_len, grp * l_len, r0,
              [](int, int, float a) { return a; });
        return;
    }

    // ---- h1 rows r0.. of N: (k * w)^T v over L, then + exp(ltot) h0
    const float ltot = lg[l_len - 1];
    const int steps = (l_len + SSD_BK - 1) / SSD_BK;
    auto issue = [&](int c) {
        float* sb = ring + (c % SSD_STAGES) * SSD_STAGE;
        const int j0 = c * SSD_BK;
        if (VQK)
            stage16<SSD_BK, SSD_BM>(sb, SSD_LDT, kg, l_len, n_dim, j0, r0,
                                    SSD_BM);
        else
            stage4<SSD_BK, SSD_BM>(sb, SSD_LDT, kg, l_len, n_dim, j0, r0,
                                   SSD_BM);
        stage_rows<SSD_BK, SSD_SLAB, VVH>(
            sb + SSD_VOFF, SSD_LDV, reinterpret_cast<int*>(sb + SSD_SOFF),
            vg, l_len, p_dim, j0, pb, sw);
        if (tid < SSD_BK)
            sb[SSD_XOFF + tid] = j0 + tid < l_len
                ? expf(__fsub_rn(ltot, lg[j0 + tid])) : 0.0f;
    };
    for (int s = 0; s < SSD_STAGES - 1; ++s) {
        if (s < steps) issue(s);
        cp_async_commit();
    }
    for (int c = 0; c < steps; ++c) {
        cp_async_wait<SSD_STAGES - 2>();
        __syncthreads();
        if (c + SSD_STAGES - 1 < steps) issue(c + SSD_STAGES - 1);
        cp_async_commit();
        const float* sb = ring + (c % SSD_STAGES) * SSD_STAGE;
        const int* shv = reinterpret_cast<const int*>(sb + SSD_SOFF);
#pragma unroll
        for (int kk = 0; kk < SSD_BK / 2; kk += 8) {
            const int ks = half * (SSD_BK / 2) + kk;
            mma_rows(acc, load_frag_a_kw(sb, SSD_LDT, sb + SSD_XOFF, rw, ks),
                     sb + SSD_VOFF, shv, ks, colw);
        }
    }
    const float decay = expf(ltot);
    store(h1, n_dim, grp * n_dim, r0, [&](int n, int col, float a) {
        return __fadd_rn(__fmul_rn(hg[(int64_t)n * p_dim + col], decay), a);
    });
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
    SsdShape sh;
    sh.g = g;
    sh.l = l_len;
    sh.n = n_dim;
    sh.p = p_dim;
    sh.ldq = (n_dim + SSD_KS - 1) / SSD_KS * SSD_KS + 4;
    const int ptiles = (p_dim + 7) / 8;
    sh.ns = (ptiles + 2 * SSD_NT - 1) / (2 * SSD_NT);
    sh.slab_tiles = (ptiles + sh.ns - 1) / sh.ns;
    sh.rt = (l_len + SSD_BM - 1) / SSD_BM;
    const int h1_tiles = (n_dim + SSD_BM - 1) / SSD_BM;
    const int64_t blocks = (int64_t)g * sh.ns * (sh.rt + h1_tiles);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    auto aligned = [](const void* ptr) {
        return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    };
    const bool vqk = n_dim % 4 == 0 && aligned(q) && aligned(k);
    const bool vvh = aligned(v) && aligned(h0);
    const auto kernel =
        vqk ? (vvh ? ssd_chunk_kernel<true, true>
                   : ssd_chunk_kernel<true, false>)
            : (vvh ? ssd_chunk_kernel<false, true>
                   : ssd_chunk_kernel<false, false>);
    const size_t smem = sizeof(float) * (
        (size_t)SSD_STAGES * SSD_STAGE + (size_t)SSD_BM * sh.ldq
        + (size_t)SSD_BM * SSD_LDS + 2 * SSD_BM);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, SSD_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(lcum),
        static_cast<const float*>(h0), sh, static_cast<float*>(y),
        static_cast<float*>(h1));
    return (int)cudaGetLastError();
}
