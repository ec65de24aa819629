// link_score for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/link_score.py::_link_score_pallas (body
// _link_score_kernel). For every (source, item) pair
//   scores[b, i] = relu(hs[b] @ W1[:D] + hi[i] @ W1[D:] + b1) . w2 + b2
// without the (B, I, D) hidden tensor, or either factor, reaching device
// memory. No top-k here: the TPU kernel leaves it outside too.
//
// One launch. A block owns T::TI items (80 or 160, below) and walks its
// share of the source tiles (LS_TB sources each; more tiles go along the
// grid's second axis, `per` of them a block). For each tile and each pass
// over LS_COLS columns of the factors (one pass for D <= 128):
//  1. factors: the item factor C = hi[tile] @ W1[D:] (T::TI x LS_COLS) and
//     the source factor A = hs[tile] @ W1[:D] (LS_TB x LS_COLS), both on
//     the tensor cores at fp32 grade (three TF32 mma.sync products a step,
//     tf32x3.cuh), computed transposed (W1's columns are the mma's rows,
//     the items and sources its 8-wide n tiles). The tile's rows are
//     staged whole, a depth block of LS_COLS at a time, into the space C
//     and A take afterwards; W1's two halves stream through a three-stage
//     cp.async ring, LS_KC deep. Copies are 16 bytes wide where D % 4 == 0
//     and the three pointers are aligned (the engine's h[B:] view starts
//     B D 4 bytes into h), else 4 bytes; zero-filled past B, I and D. Each
//     warp owns 32 columns x 40 items of C and a sixteenth of A. C stays
//     in shared memory for the block's later source tiles (recomputed only
//     when D takes several passes); A gets b1 added (A + b1 + C, where the
//     plain version adds b1 last: one rounding apart, far inside TOL).
//  2. pairs, on the FMA units: thread (dq, sg, ig) owns 4 sources x 5
//     items (ig + T::IL j) over a quarter dq of the pass's columns, so a
//     pair-depth element costs an add, a max and an FMA, and its shared
//     loads (float4 along d: 4 of A, 5 of C and one of w2 per 4 columns)
//     stay far below them. Factor rows are LS_LDF = 132 floats apart
//     (16-byte aligned, 4 mod 32: eight consecutive rows' float4s hit
//     eight bank groups).
//  3. the four quarters' sums meet in shared memory, added in quarter
//     order, and the passes' sums in pass order (in shared memory, so no
//     register lives across the factors' products); b2 is added as the
//     scores go out coalesced along I.
//
// Bound on this card: at serving's top-k shape (B = 16, I = 20,000,
// D = 128) the two factors, 0.66 GFLOP as three TF32 products each, at the
// TF32 peak, and the pair pass, 41 M pair-depth elements of 3 instructions
// at the fp32 rate, each take a few microseconds, against 10 MB of item
// rows. Timed on the H100, mma.sync's TF32 rate is about half that peak,
// and every block streams all of W1 (128 KB at D = 128) from L2, so the
// products and W1's traffic set the time, then the pair pass; the three
// add up more than they overlap. Two block shapes, chosen per call:
//  - 80 items, 8 warps, two blocks a multiprocessor: while 80-item blocks
//    put at most one on each multiprocessor (I <= 80 x its count), the
//    fewest items a multiprocessor (CONFIG, 16 x 200: three blocks);
//  - 160 items, 16 warps, one block a multiprocessor: past that, the same
//    items a multiprocessor with W1 streamed half as often and A made half
//    as often. I = 20,000 gives 125 blocks on 132 SMs (160 items on the
//    busiest against 152 on average), where 128-item blocks would leave
//    157 (two on 25 SMs: 256 items on the busiest).
// Every source tile makes its own A (16 rows: a tenth of the products at
// 160 items) rather than a second launch making A once.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32x3.cuh"

namespace {

constexpr int LS_NJ = 5;          // items a pair thread
constexpr int LS_TB = 16;         // sources a tile: two n tiles
constexpr int LS_COLS = 128;      // factor columns a pass: 8 m tiles
constexpr int LS_KC = 16;         // depth of a ring stage: two mma steps
constexpr int LS_STAGES = 3;
constexpr int LS_LDW = 2 * LS_COLS + 8;   // 264, 8 mod 32: W1 k-major
// the factor tiles, and the rows staged in their place (n-major B): 132,
// 4 mod 8 and 4 mod 32
constexpr int LS_LDF = LS_COLS + 4;
// a ring stage: LS_KC rows of W1, source half | item half
constexpr int LS_STAGE = LS_KC * LS_LDW;
constexpr int LS_RING = LS_STAGES * LS_STAGE;

// The block's shape by IG, its warp rows along the items: 2 (8 warps, 80
// items, two blocks a multiprocessor) or 4 (16 warps, 160 items, one).
template <int IG>
struct Tile {
    static constexpr int THREADS = 128 * IG;   // 4 column warps a row
    static constexpr int BLOCKS = 4 / IG;      // blocks a multiprocessor
    static constexpr int IL = 8 * IG;          // pair threads along items
    static constexpr int TI = IL * LS_NJ;      // items: 8 LS_NJ a warp row
    static constexpr int MTA = 4 / IG;         // A's m tiles a warp
    // shared floats: the ring, C, A, b1 and w2 of the pass, the scores
    static constexpr int C = LS_RING;
    static constexpr int A = C + TI * LS_LDF;
    static constexpr int B1 = A + LS_TB * LS_LDF;
    static constexpr int W2 = B1 + LS_COLS;
    static constexpr int SUM = W2 + LS_COLS;
    static constexpr int SMEM = (int)sizeof(float) * (SUM + LS_TB * TI);
    static_assert(THREADS == 4 * (LS_TB / 4) * IL, "pair threads");
    static_assert(LS_NJ * THREADS == LS_TB * TI, "pairs a thread");
    static_assert(4 * LS_TB * TI <= LS_RING, "quarter sums in the ring");
    static_assert(C % 4 == 0 && A % 4 == 0 && W2 % 4 == 0, "float4 tiles");
};

// A fragment of rows m0 .. m0 + 15 (W1's columns), depth 0 .. 7 of a
// k-major tile (row stride ld, 8 mod 32: the 32 reads hit 32 banks)
__device__ __forceinline__ FragA load_frag_a_kmajor(const float* ws, int ld,
                                                    int m0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = ws + t * ld + m0 + g;
    return frag_a(p[0], p[8], p[4 * ld], p[4 * ld + 8]);
}

__device__ __forceinline__ float pair_step(float acc, float a, float c,
                                           float w) {
    return fmaf(fmaxf(a + c, 0.0f), w, acc);
}

// Step 1 for the block's items i0.. (ITEMS) and sources b0..: C and A + b1
// of columns n0 .. n0 + LS_COLS - 1 into their shared tiles. The depth
// runs in blocks of LS_COLS: each block's rows are staged whole into the
// tiles' own space (item rows where C goes, source rows where A goes),
// W1's rows stream through the ring. VEC: 16-byte copies (D % 4 == 0,
// pointers aligned), else 4-byte ones.
template <int IG, bool VEC, bool ITEMS>
__device__ __forceinline__ void factors(
        const float* __restrict__ hs, const float* __restrict__ hi,
        const float* __restrict__ w1, int nb, int ni, int d, int b0, int i0,
        int n0, float* __restrict__ smem) {
    using T = Tile<IG>;
    constexpr int HALVES = ITEMS ? 2 : 1;
    constexpr int ROWS = ITEMS ? LS_TB + T::TI : LS_TB;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int cg = warp & 3;     // columns cg * 32 ..
    const int ih = warp >> 2;    // items ih * 8 NJ ..
    // A's 16 tiles (8 m x 2 n): m tiles ma.. (T::MTA of them) x n tile na
    const int ma = cg * 2 + (ih % (IG / 2)) * T::MTA;
    const int na = ih / (IG / 2);
    // a warp whose columns all lie past D only writes zeros
    const bool live = n0 + cg * 32 < d;
    float* as = smem + T::A;     // source rows, then A + b1
    float* cs = smem + T::C;     // item rows, then C

    // the tile's rows r (sources, then items) at depth kb .. kb + LS_COLS - 1
    auto stage_rows = [&](int kb) {
        const int per_row = VEC ? LS_COLS / 4 : LS_COLS;
        for (int e = tid; e < ROWS * per_row; e += T::THREADS) {
            const int r = e / per_row;
            const int col = VEC ? 4 * (e % per_row) : e % per_row;
            const bool src = r < LS_TB;
            const float* base = src ? hs : hi;
            const int row = src ? b0 + r : i0 + r - LS_TB;
            float* dst = (src ? as + r * LS_LDF : cs + (r - LS_TB) * LS_LDF)
                         + col;
            const float* from = base + (int64_t)row * d + kb + col;
            const bool ok = row < (src ? nb : ni);
            if (VEC)
                cp_async16(dst, from,
                           ok ? 4 * min(4, max(0, d - kb - col)) : 0, base);
            else
                cp_async4(dst, from, ok && kb + col < d, base);
        }
    };
    // W1's rows k0 .. k0 + LS_KC - 1 of the source half (and the item
    // half), columns n0.., into ring slot c % LS_STAGES
    auto issue = [&](int c, int k0) {
        float* ws = smem + (c % LS_STAGES) * LS_STAGE;
        constexpr int per_row = VEC ? LS_COLS / 4 : LS_COLS;
        for (int e = tid; e < LS_KC * HALVES * per_row; e += T::THREADS) {
            const int k = e / (HALVES * per_row);
            const int rest = e % (HALVES * per_row);
            const int half = rest / per_row;
            const int col = VEC ? 4 * (rest % per_row) : rest % per_row;
            float* dst = ws + k * LS_LDW + half * LS_COLS + col;
            const float* from =
                w1 + ((int64_t)half * d + k0 + k) * d + n0 + col;
            if (VEC)
                cp_async16(dst, from,
                           k0 + k < d ? 4 * min(4, max(0, d - n0 - col)) : 0,
                           w1);
            else
                cp_async4(dst, from, k0 + k < d && n0 + col < d, w1);
        }
    };

    // transposed tiles: acc_a[mt] columns (ma + mt) * 16 .. x sources
    // na * 8 ..; acc_c[mt][nt] columns cg * 32 + mt * 16 .. x items
    // (ih * LS_NJ + nt) * 8 ..
    float acc_a[T::MTA][4], acc_c[2][LS_NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int mt = 0; mt < T::MTA; ++mt) acc_a[mt][i] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < LS_NJ; ++nt) acc_c[mt][nt][i] = 0.0f;
    }

    for (int kb = 0; kb < d; kb += LS_COLS) {
        const int nk = (min(LS_COLS, d - kb) + LS_KC - 1) / LS_KC;
        if (kb > 0) __syncthreads();   // the last depth block is read
        // the rows ride in the first chunk's group
        stage_rows(kb);
        for (int c = 0; c < LS_STAGES - 1; ++c) {
            if (c < nk) issue(c, kb + c * LS_KC);
            cp_async_commit();
        }
        for (int c = 0; c < nk; ++c) {
            cp_async_wait<LS_STAGES - 2>();
            __syncthreads();   // chunk c landed; slot (c - 1) % STAGES free
            if (c + LS_STAGES - 1 < nk)
                issue(c + LS_STAGES - 1, kb + (c + LS_STAGES - 1) * LS_KC);
            cp_async_commit();
            if (!live) continue;
            const float* ws = smem + (c % LS_STAGES) * LS_STAGE;
#pragma unroll
            for (int ks = 0; ks < LS_KC; ks += 8) {
                const int k = c * LS_KC + ks;    // depth in the block
                const FragB sb = load_frag_b_nmajor(as, LS_LDF, k, na * 8);
#pragma unroll
                for (int mt = 0; mt < T::MTA; ++mt)
                    mma_3xtf32(acc_a[mt],
                               load_frag_a_kmajor(ws + ks * LS_LDW, LS_LDW,
                                                  (ma + mt) * 16),
                               sb);
                if (ITEMS) {
                    const float* wi = ws + ks * LS_LDW + LS_COLS;
                    const FragA wa0 = load_frag_a_kmajor(wi, LS_LDW, cg * 32);
                    const FragA wa1 =
                        load_frag_a_kmajor(wi, LS_LDW, cg * 32 + 16);
#pragma unroll
                    for (int nt = 0; nt < LS_NJ; ++nt) {
                        const FragB ib = load_frag_b_nmajor(
                            cs, LS_LDF, k, (ih * LS_NJ + nt) * 8);
                        mma_3xtf32(acc_c[0][nt], wa0, ib);
                        mma_3xtf32(acc_c[1][nt], wa1, ib);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the rows

    // accumulator i holds column m0 + g + 8 (i >> 1) of its m tile and row
    // 2 t + (i & 1) of its n tile
    const float* b1s = smem + T::B1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = 2 * t + (i & 1);
#pragma unroll
        for (int mt = 0; mt < T::MTA; ++mt) {
            const int col = (ma + mt) * 16 + g + 8 * (i >> 1);
            as[(na * 8 + r) * LS_LDF + col] = acc_a[mt][i] + b1s[col];
        }
        if (ITEMS) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < LS_NJ; ++nt)
                    cs[((ih * LS_NJ + nt) * 8 + r) * LS_LDF + cg * 32
                       + mt * 16 + g + 8 * (i >> 1)] = acc_c[mt][nt][i];
        }
    }
}

template <int IG, bool VEC>
__global__ void __launch_bounds__(Tile<IG>::THREADS, Tile<IG>::BLOCKS)
link_score_kernel(
        const float* __restrict__ hs, const float* __restrict__ hi,
        const float* __restrict__ w1, const float* __restrict__ b1,
        const float* __restrict__ w2, const float* __restrict__ b2,
        int nb, int ni, int d, int per, float* __restrict__ out) {
    using T = Tile<IG>;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * T::TI;
    const int npass = (d + LS_COLS - 1) / LS_COLS;
    // the pair thread's quarter of the columns, sources 4 sg .., items
    // ig + T::IL j
    const int dq = tid / (4 * T::IL), sg = (tid / T::IL) & 3;
    const int ig = tid % T::IL;
    const float4* a4 = reinterpret_cast<const float4*>(smem + T::A)
                       + sg * 4 * (LS_LDF / 4);
    const float4* c4 = reinterpret_cast<const float4*>(smem + T::C)
                       + ig * (LS_LDF / 4);
    const float4* w4 = reinterpret_cast<const float4*>(smem + T::W2);
    const float bias = b2[0];

    for (int s = 0; s < per; ++s) {
        const int b0 = (blockIdx.y * per + s) * LS_TB;
        if (b0 >= nb) break;
        for (int p = 0; p < npass; ++p) {
            const int n0 = p * LS_COLS;
            if (tid < LS_COLS) {
                const bool ok = n0 + tid < d;
                smem[T::B1 + tid] = ok ? b1[n0 + tid] : 0.0f;
                smem[T::W2 + tid] = ok ? w2[n0 + tid] : 0.0f;
            }
            if (s == 0 || npass > 1)
                factors<IG, VEC, true>(hs, hi, w1, nb, ni, d, b0, i0, n0,
                                       smem);
            else
                factors<IG, VEC, false>(hs, hi, w1, nb, ni, d, b0, i0, n0,
                                        smem);
            __syncthreads();   // A and C written
            // columns of the pass rounded up to 16 (zeros past D: A, C and
            // w2 are 0 there), a quarter each
            const int fq = ((min(LS_COLS, d - n0) + 15) & ~15) / 16;
            float acc[4][LS_NJ];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int j = 0; j < LS_NJ; ++j) acc[q][j] = 0.0f;
            for (int f = dq * fq; f < (dq + 1) * fq; ++f) {
                const float4 w = w4[f];
                float4 av[4], cv[LS_NJ];
#pragma unroll
                for (int q = 0; q < 4; ++q) av[q] = a4[q * (LS_LDF / 4) + f];
#pragma unroll
                for (int j = 0; j < LS_NJ; ++j)
                    cv[j] = c4[T::IL * j * (LS_LDF / 4) + f];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int j = 0; j < LS_NJ; ++j) {
                        float r = acc[q][j];
                        r = pair_step(r, av[q].x, cv[j].x, w.x);
                        r = pair_step(r, av[q].y, cv[j].y, w.y);
                        r = pair_step(r, av[q].z, cv[j].z, w.z);
                        acc[q][j] = pair_step(r, av[q].w, cv[j].w, w.w);
                    }
            }
            __syncthreads();   // the tiles and the ring may be rewritten
            // the quarters' sums meet in the ring, added in quarter order
            float* red = smem;
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int j = 0; j < LS_NJ; ++j)
                    red[dq * (LS_TB * T::TI) + (sg * 4 + q) * T::TI + ig
                        + T::IL * j] = acc[q][j];
            __syncthreads();
            // pair e = tid + T::THREADS k (source e / T::TI, item e % T::TI):
            // its sum over the passes so far, in shared memory
            float* sum = smem + T::SUM;
#pragma unroll
            for (int k = 0; k < LS_NJ; ++k) {
                const int e = tid + T::THREADS * k;
                const float v = ((red[e] + red[LS_TB * T::TI + e])
                                 + red[2 * LS_TB * T::TI + e])
                                + red[3 * LS_TB * T::TI + e];
                sum[e] = p == 0 ? v : sum[e] + v;
            }
            __syncthreads();   // before the next pass's ring
        }
        // out along I
#pragma unroll
        for (int k = 0; k < LS_NJ; ++k) {
            const int e = tid + T::THREADS * k;
            const int r = e / T::TI, i = e % T::TI;
            if (b0 + r < nb && i0 + i < ni)
                out[(int64_t)(b0 + r) * ni + i0 + i] =
                    smem[T::SUM + e] + bias;
        }
    }
}

// Launch the kernel of block shape IG over the grid: item tiles along x;
// the source tiles split into as few groups along y as fill the
// multiprocessors, `per` tiles a group.
template <int IG, bool VEC>
int launch(const float* hs, const float* hi, const float* w1,
           const float* b1, const float* w2, const float* b2, int nb, int ni,
           int d, int sms, float* out, cudaStream_t st) {
    using T = Tile<IG>;
    const int gx = (ni + T::TI - 1) / T::TI;
    const int tiles = (nb + LS_TB - 1) / LS_TB;
    const int fill = T::BLOCKS * sms;
    int groups = std::min(tiles, std::max(1, (fill + gx - 1) / gx));
    const int per = (tiles + groups - 1) / groups;
    groups = (tiles + per - 1) / per;
    if (groups > 65535) return (int)cudaErrorInvalidValue;
    const auto kernel = link_score_kernel<IG, VEC>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(gx, groups), T::THREADS, T::SMEM, st>>>(
        hs, hi, w1, b1, w2, b2, nb, ni, d, per, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_link_score(const void* h_src, const void* h_items,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2, int nb,
                                int ni, int d, void* out, void* stream) {
    if (nb <= 0 || ni <= 0) return 0;
    if (d < 1) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vec = d % 4 == 0 && aligned(h_src) && aligned(h_items) &&
                     aligned(w1);
    // 160-item blocks once 80-item ones would put two on a multiprocessor:
    // the same items a multiprocessor, W1 read half as often
    const bool wide = (ni + Tile<2>::TI - 1) / Tile<2>::TI > sms;
    const auto run = wide ? (vec ? launch<4, true> : launch<4, false>)
                          : (vec ? launch<2, true> : launch<2, false>);
    return run(static_cast<const float*>(h_src),
               static_cast<const float*>(h_items),
               static_cast<const float*>(w1), static_cast<const float*>(b1),
               static_cast<const float*>(w2), static_cast<const float*>(b2),
               nb, ni, d, sms, static_cast<float*>(out),
               static_cast<cudaStream_t>(stream));
}
