// The GRU cell's row tile on Hopper's tensor cores, shared by gru_cell.cu
// and memory_update.cu (the table kernel and the dense memory_update).
//
// The cell is the JAX package's (models/modules.py::gru_cell):
//   r = sigmoid(x W_r + b_r + h U_r),  z = sigmoid(x W_z + b_z + h U_z)
//   n = tanh(x W_n + b_n + r * (h U_n)),   h' = (1 - z) h + z n
// with no hidden bias and z weighting n (PyTorch's GRUCell weights h by z).
//
// A block owns a tile of GT_ROWS rows and GT_COLS output columns j and runs
// both products on the tensor cores at fp32 grade (three TF32 products a
// step, tf32x3.cuh). Its eight warps split the depth: four take x W, four
// h U, each warp 16 rows x the 16 columns with, per 8-column group, one
// accumulator tile per gate panel. The h half hands its sums to the x half
// through shared memory; the x half passes each (row, column)'s six sums
// and the exact fp32 h value (read from memory, not from the TF32 split)
// to the caller's epilogue, which forms the gates with gru_gates (the
// plain version's order, (x W + b) + h U) and whatever follows them. Both
// halves' depth chunks stream through a three-stage cp.async ring (GT_KC
// deep: the row tile's chunk and the three gate panels of W or U the
// block's columns need; 16-byte copies where the widths allow), so no
// width is limited by shared memory. Rows past M and columns past D are
// zero-filled in the ring and never handed to the epilogue.
//
// With GATHER, row r's h is h[gidx[r]] (an index outside [0, n_h) reads
// zeros, through the copies' zero-fill): the block stages its rows' source
// indices once, in shared memory, before the ring starts. Occurrences come
// grouped by node, so a hot node fills runs of rows with one source row,
// and many copies of one address serialize in L2 (timed on the H100: one
// node on half of M = 2,048 rows doubled the kernel's time). So only the
// first row of a run of equal sources is copied, and the h half's
// fragments read every row of the run from that one.
//
// At these sizes (M = 2000, D = Din = 128: 0.20 GFLOP against 3.5 MB) the
// time goes to the launch, the ring's fill and the instructions around the
// products (fragment loads, operand splits; timed on the H100, the
// mma.sync themselves hide behind them), which is why the depth is split
// across twice the warps. M = 2000, D = 128 gives 32 x 8 = 256 blocks of
// 256 threads, two resident on each multiprocessor.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int GT_ROWS = 64;      // rows per block: a 16-row mma tile a warp
constexpr int GT_COLS = 16;      // output columns per block: two 8-wide groups
constexpr int GT_THREADS = 256;  // two halves of four warps: x W and h U
constexpr int GT_KC = 32;        // depth of one pipeline stage
constexpr int GT_STAGES = 3;
constexpr int GT_LDA = GT_KC + 4;          // 36: 4 mod 8
constexpr int GT_LDB = 3 * GT_COLS + 8;    // 56: 24 mod 32
constexpr int GT_HALF = GT_ROWS * GT_LDA + GT_KC * GT_LDB;
constexpr int GT_STAGE = 2 * GT_HALF;      // an x chunk and an h chunk
// dynamic shared memory of a block (the ring), bytes
constexpr int GT_SMEM = (int)sizeof(float) * GT_STAGES * GT_STAGE;

// one (row, column)'s gate sums: x W and h U of each gate panel, apart
struct GruSums {
    float xr, xz, xn, hr, hz, hn;
};

__device__ __forceinline__ float gt_sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// h'[row, j] from its sums and h[row, j], in the plain version's order
__device__ __forceinline__ float gru_gates(const GruSums& s,
                                           const float* __restrict__ b,
                                           int d, int j, float hv) {
    const float rg = gt_sigmoid((s.xr + b[j]) + s.hr);
    const float zg = gt_sigmoid((s.xz + b[d + j]) + s.hz);
    const float ng = tanhf((s.xn + b[2 * d + j]) + rg * s.hn);
    return (1.0f - zg) * hv + zg * ng;
}

// The tile of block (blockIdx.x, blockIdx.y): rows blockIdx.x * GT_ROWS..,
// columns blockIdx.y * GT_COLS... `ring` is the block's GT_SMEM bytes of
// dynamic shared memory. epi(row, j, sums, h[row, j]) runs once for each
// row < m and j < d, on a thread of the x half; the h half returns first.
// VEC: Din and D multiples of 4 and x, h, w, u 16-byte aligned (16-byte
// copies); else 4-byte copies.
template <bool VEC, bool GATHER, class Epilogue>
__device__ __forceinline__ void gru_tile(
        const float* __restrict__ x, int din,
        const float* __restrict__ h, int64_t n_h, int d,
        const int32_t* __restrict__ gidx,
        const float* __restrict__ w, const float* __restrict__ u, int m,
        float* __restrict__ ring, Epilogue epi) {
    __shared__ int hrow[GT_ROWS];          // GATHER: h's source row, or -1
    __shared__ int hrep[GT_ROWS];          // GATHER: first row of r's run
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int half = warp >> 2;            // 0: x W, 1: h U
    const int row_w = (warp & 3) * 16;     // the warp's rows in the tile
    const int htid = tid & (GT_THREADS / 2 - 1);
    const int row0 = blockIdx.x * GT_ROWS;
    const int col0 = blockIdx.y * GT_COLS;
    const int64_t d3 = 3 * (int64_t)d;
    const float* a = half ? h : x;         // this half's rows and panels
    const float* wt = half ? u : w;
    const int kd = half ? d : din;
    const int nk = (kd + GT_KC - 1) / GT_KC;
    const int ns = max((din + GT_KC - 1) / GT_KC, (d + GT_KC - 1) / GT_KC);
    const bool gather = GATHER && half;

    if (GATHER) {
        static_assert(GT_ROWS == 64, "warp 0 stages two rows a lane");
        if (tid < 32) {
            // rows tid and tid + 32: their source rows, then the first row
            // of each one's run (from the lanes where a run starts)
            auto source = [&](int r) {
                if (row0 + r >= m) return -1;
                const int g = gidx[row0 + r];
                return g >= 0 && g < n_h ? g : -1;
            };
            const unsigned all = 0xffffffffu;
            const int s0 = source(tid), s1 = source(tid + 32);
            const int up0 = __shfl_up_sync(all, s0, 1);
            const int up1 = __shfl_up_sync(all, s1, 1);
            const int last0 = __shfl_sync(all, s0, 31);
            const unsigned b0 = __ballot_sync(all, tid == 0 || up0 != s0);
            const unsigned b1 = __ballot_sync(all,
                                              (tid == 0 ? last0 : up1) != s1);
            const unsigned upto = all >> (31 - tid);     // lanes 0 .. tid
            const int first0 = 31 - __clz(b0 & upto);
            const int run31 = __shfl_sync(all, first0, 31);
            hrow[tid] = s0;
            hrow[tid + 32] = s1;
            hrep[tid] = first0;
            hrep[tid + 32] = (b1 & upto) ? 63 - __clz(b1 & upto) : run31;
        }
        __syncthreads();
    }
    // row r of this half's operand: its row in memory, or -1 (zeros)
    auto src_row = [&](int r) {
        if (gather) return hrow[r];
        return row0 + r < m ? row0 + r : -1;
    };

    // step c into ring slot c % GT_STAGES: each half copies its chunk c (if
    // it has one): the row tile's columns k0 .. k0 + GT_KC - 1 of x (or h)
    // and those rows of the gate panels of W (or U) at the block's columns
    // (r, z, n side by side)
    auto issue = [&](int c) {
        float* as = ring + (c % GT_STAGES) * GT_STAGE + half * GT_HALF;
        float* bs = as + GT_ROWS * GT_LDA;
        if (c >= nk) return;
        const int k0 = c * GT_KC;
        if (VEC) {
            for (int e = htid; e < GT_ROWS * GT_KC / 4; e += GT_THREADS / 2) {
                const int r = e / (GT_KC / 4), k = 4 * (e % (GT_KC / 4));
                if (gather && hrep[r] != r) continue;
                const int n = min(4, max(0, kd - k0 - k));
                const int sr = src_row(r);
                cp_async16(as + r * GT_LDA + k,
                           a + (int64_t)sr * kd + k0 + k,
                           sr >= 0 ? 4 * n : 0, a);
            }
            for (int e = htid; e < GT_KC * 3 * GT_COLS / 4;
                 e += GT_THREADS / 2) {
                const int k = e / (3 * GT_COLS / 4);
                const int n = 4 * (e % (3 * GT_COLS / 4));
                const int gate = n / GT_COLS, j = col0 + n % GT_COLS;
                const int live = min(4, max(0, d - j));
                cp_async16(bs + k * GT_LDB + n,
                           wt + (int64_t)(k0 + k) * d3 + (int64_t)gate * d + j,
                           k0 + k < kd ? 4 * live : 0, wt);
            }
        } else {
            for (int e = htid; e < GT_ROWS * GT_KC; e += GT_THREADS / 2) {
                const int r = e / GT_KC, k = e % GT_KC;
                if (gather && hrep[r] != r) continue;
                const int sr = src_row(r);
                const bool ok = sr >= 0 && k0 + k < kd;
                cp_async4(as + r * GT_LDA + k,
                          a + (int64_t)sr * kd + k0 + k, ok, a);
            }
            for (int e = htid; e < GT_KC * 3 * GT_COLS; e += GT_THREADS / 2) {
                const int k = e / (3 * GT_COLS), n = e % (3 * GT_COLS);
                const int gate = n / GT_COLS, j = col0 + n % GT_COLS;
                const bool ok = k0 + k < kd && j < d;
                cp_async4(bs + k * GT_LDB + n,
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

    // the h half's fragment rows (g and g + 8 of the warp's 16) in its
    // tile: with GATHER, the first row of each one's run
    const int g = lane >> 2, t = lane & 3;
    int off0 = (row_w + g) * GT_LDA, off8 = (row_w + g + 8) * GT_LDA;
    if (gather) {
        off0 = hrep[row_w + g] * GT_LDA;
        off8 = hrep[row_w + g + 8] * GT_LDA;
    }

    for (int s = 0; s < GT_STAGES - 1; ++s) {
        if (s < ns) issue(s);
        cp_async_commit();
    }
    for (int c = 0; c < ns; ++c) {
        cp_async_wait<GT_STAGES - 2>();
        __syncthreads();   // step c landed; slot (c - 1) % 3 is free
        if (c + GT_STAGES - 1 < ns) issue(c + GT_STAGES - 1);
        cp_async_commit();
        if (c >= nk) continue;
        const float* as = ring + (c % GT_STAGES) * GT_STAGE + half * GT_HALF;
        const float* bs = as + GT_ROWS * GT_LDA;
#pragma unroll
        for (int ks = 0; ks < GT_KC; ks += 8) {
            const FragA fa =
                gather ? load_frag_a_rows(as, off0, off8, ks)
                       : load_frag_a<false>(as, GT_LDA, row_w, ks, GT_KC);
#pragma unroll
            for (int cg = 0; cg < 2; ++cg)
#pragma unroll
                for (int gate = 0; gate < 3; ++gate)
                    mma_3xtf32(acc[cg][gate], fa,
                               load_frag_b(bs, GT_LDB, ks,
                                           gate * GT_COLS + cg * 8));
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
#pragma unroll
    for (int cg = 0; cg < 2; ++cg)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row_w + g + (i >> 1) * 8;
            const int row = row0 + r;
            const int j = col0 + cg * 8 + 2 * t + (i & 1);
            if (row < m && j < d) {
                int64_t hr = row;
                if (GATHER) hr = hrow[r];
                const float hv = hr >= 0 ? h[hr * d + j] : 0.0f;
                const GruSums s = {acc[cg][0][i], acc[cg][1][i],
                                   acc[cg][2][i],
                                   red[((cg * 3 + 0) * 4 + i) * 32],
                                   red[((cg * 3 + 1) * 4 + i) * 32],
                                   red[((cg * 3 + 2) * 4 + i) * 32]};
                epi(row, j, s, hv);
            }
        }
}

// The host half, shared by gru_cell.cu and memory_update.cu: launches
// vec_kernel (VEC true) when Din and D are multiples of 4 and x, h, w and
// u are 16-byte aligned, else plain_kernel, over the tile grid of m rows
// and d output columns with GT_SMEM bytes of ring; args are the kernel's.
template <class Kernel, class... Args>
int gru_tile_launch(Kernel vec_kernel, Kernel plain_kernel, const void* x,
                    int din, const void* h, int d, const void* w,
                    const void* u, int m, cudaStream_t st, Args... args) {
    if (din < 1 || d < 1) return (int)cudaErrorInvalidValue;
    auto aligned = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool vec = din % 4 == 0 && d % 4 == 0 && aligned(x) &&
                     aligned(h) && aligned(w) && aligned(u);
    const Kernel kernel = vec ? vec_kernel : plain_kernel;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GT_SMEM);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((m + GT_ROWS - 1) / GT_ROWS, (d + GT_COLS - 1) / GT_COLS);
    kernel<<<grid, GT_THREADS, GT_SMEM, st>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace
