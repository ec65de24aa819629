// flash_attn on bf16 inputs for Hopper (sm_90a): wgmma tensor-core products
// fed by TMA, plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attn.py::_flash_attn_pallas (:73) for
// bfloat16 q, k and v (float32 inputs take csrc/flash_attn.cu). It computes
// what the TPU kernel computes: attention of G query groups over Gkv kv
// groups, group g reading kv group g / (G / Gkv),
//   s_ij = (q_i . k_j) / sqrt(D), set to -1e30 where masked (k_pos > q_pos
//          when causal, k_pos <= q_pos - window when windowed)
// with an online softmax over kv tiles: a running max m (from -1e30), a
// denominator l and an fp32 accumulator rescaled by exp(m_old - m_new) at
// each tile, out = acc / max(l, 1e-30), rounded to bf16 (nearest even).
//
// Design. One block (CTA) owns a (kv group, 64-row query tile) and up to
// two of the kv group's query groups: each gets a consumer warpgroup of
// 128 threads and its own 64 query rows, so the two share every K/V tile
// (for qwen3, n_rep = 2, K/V traffic halves). A larger n_rep takes more
// blocks; an odd one leaves the last block's second warpgroup idle. One
// thread of the producer (the warp after the consumers, or with two
// consumers a whole warpgroup: PRODUCER_REGS below) loads Q once and 64-key
// tiles of K and V by TMA into a three-stage ring guarded by full / empty
// mbarriers. Tensor maps are 3-d (D, rows, group) with 64-column boxes and
// the 128-byte swizzle, so a row's D columns sit in 128-byte panels: D is
// zero-padded to the next multiple of 64 (DP) by TMA's out-of-bounds fill,
// and so are the rows past S or T.
//   q k^T: wgmma m64n64k16, bf16 x bf16 -> fp32, Q and K from shared memory
//     (both K-major). Products of bf16 values are exact in fp32, so the
//     scores are the fp32 scores of the bf16 inputs up to summation order,
//     as the TPU kernel's (preferred_element_type=float32 on fp32-cast
//     inputs).
//   softmax on the score fragment in registers: the scores times
//     1 / sqrt(D) (the TPU kernel's scale), expf (no fast math).
//   P V: the usual bf16 P (what SDPA does) misses the port's one-ulp check
//     against the fp32 plain version, so p is split into p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), and two wgmma m64n64k16 (A = p_hi, then p_lo,
//     from registers; B = V from shared memory, MN-major: the transposed-B
//     form) add into one fp32 accumulator per 64-column panel of the
//     output. p_hi + p_lo carries p to about 2^-16 of itself.
// Masks follow csrc/flash_attn.cu: kv tiles wholly masked for the query
// tile are skipped unless a window leaves some row of the tile with no
// valid key (the plain version then returns the mean of v, so such a tile
// takes every kv tile); keys past T weigh exactly 0; only the diagonal and
// edge tiles are masked element by element. The longest causal query
// tiles start first.
//
// Bound on this card: operations. At the qwen3 prefill shape (G = 32,
// Gkv = 16, S = T = 8,192, D = 128, causal) the two products need about
// 550 GFLOP, 0.556 ms at the 989 TFLOP/s dense bf16 tensor-core rate
// (bytes: about 0.1 GB, 0.03 ms). The split of P makes P V two products,
// so the tensor cores do 1.5x the algorithm's work: 0.83 ms at that rate.
// Within a warpgroup, tile i's P V and tile i + 1's q k^T are issued
// together and tile i + 1's softmax runs under them; two warpgroups a
// block overlap each other as the scheduler lets them. What holds the
// kernel back is the softmax's fp32 work a score (the scale, the max,
// expf, the split), not the tensor cores or the TMA feed. Persistent
// blocks, a larger key tile, a consumer ping-pong and clusters are later
// work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                 // query rows per consumer warpgroup
constexpr int BN = 64;                 // keys per K / V tile
constexpr int PANEL = 64;              // bf16 columns in a 128-byte panel
constexpr int ROW_BYTES = 128;
constexpr int STAGES = 3;              // K / V ring
constexpr int WG = 128;                // threads in a warpgroup
// Two consumer warpgroups and a producer warp would put three warps on one
// of the SM's four sub-partitions (16K registers each) and cap every thread
// at 168 registers. So with NC = 2 the producer is a whole warpgroup that
// gives its registers to the consumers (setmaxnreg): 24 + 2 x 240 a
// sub-partition.
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int NC>
constexpr int block_threads() { return NC * WG + (NC == 2 ? WG : 32); }
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Wait until the phase of `parity` has completed. A wait that lasts 10 s
// can only be a fault of the pipeline: trap, so that the launch fails
// instead of hanging the card.
// WARP: a whole warp waits and takes lane 0's answer, so that it leaves
// the loop together (the phase cannot move on before the warp arrives).
template <bool WARP>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint64_t t0 = 0;
    for (uint32_t n = 0;; ++n) {
        uint32_t done;
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (WARP) done = __shfl_sync(FULL, done, 0);
        if (done) return;
        if ((n & 1023u) == 0) {
            const uint64_t now = global_ns();
            if (t0 == 0) t0 = now;
            else if (now - t0 > 10000000000ull) __trap();
        }
    }
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). A K-major operand (Q, K) reads
// its 8-row groups SBO = 1024 bytes apart and never crosses a panel within
// one k16 step, so its LBO is unused. The MN-major V operand at N = 64
// spans one swizzle atom along N and two 8-key groups 1024 bytes apart
// along K; both offsets are set to 1024, so that either reading of the
// two fields finds that stride.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous instruction's issue and completion.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define FA_D32                                                               \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
    "%30, %31}"
#define FA_OUT32(d)                                                          \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),             \
    "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
    "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
    "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),         \
    "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
    "+f"(d[31])

// d (64 x 64, fp32) = A B^T (+ d when accumulate), A and B both K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : FA_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) += A B, A (64 x 16 bf16) from registers, B (16 x 64)
// MN-major in shared memory (the transposed-B form)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_OUT32(d)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// p_hi = bf16(a, b), p_lo = bf16 of what p_hi misses (lower half: a)
__device__ __forceinline__ void split_pack(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                   b - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- the kernel -----------------------------------------------------------

// DP: the padded head width (a multiple of 64); NC: consumer warpgroups.
template <int DP, int NC>
__global__ void __launch_bounds__(block_threads<NC>(), 1)
flash_attn_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        __nv_bfloat16* __restrict__ out, int gkv, int n_rep, int s_len,
        int t_len, int d, int causal, int window, float div) {
    constexpr int NP = DP / PANEL;                  // panels of a row
    constexpr int Q_BYTES = BM * DP * 2;            // one warpgroup's Q
    constexpr int TILE_BYTES = BN * DP * 2;         // one K or V tile
    extern __shared__ uint8_t fa_smem_raw[];
    // 128-byte swizzle atoms must start on a 1024-byte boundary
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(fa_smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;                             // [NC][NP][BM][128 B]
    uint8_t* ks = qs + NC * Q_BYTES;                // [STAGES][NP][BN][128 B]
    uint8_t* vs = ks + STAGES * TILE_BYTES;
    __shared__ __align__(8) uint64_t full_bar[STAGES];
    __shared__ __align__(8) uint64_t empty_bar[STAGES];
    __shared__ __align__(8) uint64_t q_bar;

    // block -> (query tile, kv group, slot of NC query groups); the last
    // (longest causal) query tiles of every group come first
    const int n_slots = (n_rep + NC - 1) / NC;
    const int per_qt = gkv * n_slots;
    const int n_qt = (s_len + BM - 1) / BM;
    const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / per_qt);
    const int rest = static_cast<int>(blockIdx.x % per_qt);
    const int kvg = rest / n_slots;
    const int slot = rest % n_slots;
    const int head0 = kvg * n_rep + slot * NC;
    const int n_active = min(NC, n_rep - slot * NC);
    const int q0 = qt * BM;
    const int q_last = min(q0 + BM, s_len) - 1;

    // kv tiles this query tile visits, [kt_lo, kt_hi); a windowed row of
    // this tile with no valid key in [0, T) ends the skipping
    const int n_kt = (t_len + BN - 1) / BN;
    int kt_lo = 0, kt_hi = n_kt;
    const bool skip_ok = window <= 0 || q_last - window < t_len - 1;
    if (skip_ok) {
        if (causal) kt_hi = min(n_kt, q_last / BN + 1);
        if (window > 0) kt_lo = max(0, (q0 - window + 1) / BN);
    }
    const int n_tiles = kt_hi - kt_lo;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full_bar[s], 1);
            mbar_init(&empty_bar[s], n_active * WG);
        }
        mbar_init(&q_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    // the warpgroup index, broadcast from lane 0 so that the compiler sees
    // it is uniform in the warp: a branch on threadIdx it cannot prove so
    // makes it serialize every wgmma of the branch
    const int wg = __shfl_sync(FULL, static_cast<int>(threadIdx.x / WG), 0);
    if (wg == NC) {
        if constexpr (NC == 2)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                         :: "n"(PRODUCER_REGS));
        // producer: one thread issues every copy
        if (threadIdx.x == NC * WG) {
            mbar_expect_tx(&q_bar, n_active * Q_BYTES);
            for (int h = 0; h < n_active; ++h)
#pragma unroll
                for (int p = 0; p < NP; ++p)
                    tma_load(qs + h * Q_BYTES + p * BM * ROW_BYTES, &tm_q,
                             &q_bar, p * PANEL, q0, head0 + h);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES;
                const uint32_t round = static_cast<uint32_t>(i / STAGES);
                mbar_wait<false>(&empty_bar[s], (round & 1u) ^ 1u);
                mbar_expect_tx(&full_bar[s], 2 * TILE_BYTES);
                const int k0 = (kt_lo + i) * BN;
#pragma unroll
                for (int p = 0; p < NP; ++p) {
                    tma_load(ks + s * TILE_BYTES + p * BN * ROW_BYTES, &tm_k,
                             &full_bar[s], p * PANEL, k0, kvg);
                    tma_load(vs + s * TILE_BYTES + p * BN * ROW_BYTES, &tm_v,
                             &full_bar[s], p * PANEL, k0, kvg);
                }
            }
        }
        return;
    }
    if constexpr (NC == 2)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(CONSUMER_REGS));
    if (wg >= n_active) return;

    // consumer warpgroup wg: query group head0 + wg. Thread (warp w, lane
    // 4 * gid + tig) holds rows 16 w + gid and + 8 of the tile; in a
    // 64 x 64 fragment, element 4 j + e is row (e >> 1) * 8 + gid, column
    // 8 j + 2 tig + (e & 1)
    const int tid = threadIdx.x % WG;
    const int gid = (tid % 32) / 4;
    const int tig = tid % 4;
    const int row0 = q0 + (tid / 32) * 16 + gid;
    const int head = head0 + wg;
    const uint32_t q_base = smem_u32(qs + wg * Q_BYTES);

    float o[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    float m_r[2] = {NEG, NEG};
    float l_r[2] = {0.f, 0.f};                      // this thread's columns
    const float scale = 1.f / div;                  // as the TPU kernel's

    // issue q k^T of tile i into sc (DP / 16 steps of k16 along the head
    // width) once its stage has arrived; the caller waits for it
    auto issue_qk = [&](float (&sc)[32], int i) {
        const int s = i % STAGES;
        mbar_wait<true>(&full_bar[s], static_cast<uint32_t>(i / STAGES) & 1u);
        const uint32_t k_base = smem_u32(ks + s * TILE_BYTES);
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t qo = (kk / 4) * BM * ROW_BYTES + (kk % 4) * 32;
            const uint32_t ko = (kk / 4) * BN * ROW_BYTES + (kk % 4) * 32;
            wgmma_ss(sc, desc_sw128(q_base + qo, 16, 1024),
                     desc_sw128(k_base + ko, 16, 1024), kk > 0);
        }
        wgmma_commit();
        fence_regs(sc);
    };

    // issue o += p_hi V + p_lo V for tile i, one 64-column panel of V at a
    // time; the caller waits for it
    auto issue_pv = [&](int i, uint32_t (&ph)[16], uint32_t (&pl)[16]) {
        const uint32_t v_base = smem_u32(vs + (i % STAGES) * TILE_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(o[p]);
        fence_regs(ph);
        fence_regs(pl);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int c = 0; c < BN / 16; ++c) {
                const uint64_t dv = desc_sw128(
                    v_base + p * BN * ROW_BYTES + c * 16 * ROW_BYTES, 1024,
                    1024);
                wgmma_rs(o[p], ph[4 * c], ph[4 * c + 1], ph[4 * c + 2],
                         ph[4 * c + 3], dv);
                wgmma_rs(o[p], pl[4 * c], pl[4 * c + 1], pl[4 * c + 2],
                         pl[4 * c + 3], dv);
            }
        wgmma_commit();
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    };

    // the softmax of tile i on its scores in sc: scale and mask them, take
    // the new row max m and alpha = exp(m_old - m) (which o and l take),
    // leave p = exp(s - m) in sc and add it to l
    auto softmax = [&](float (&sc)[32], int i, float (&alpha)[2]) {
        const int k0 = (kt_lo + i) * BN;
        const bool full_tile = k0 + BN <= t_len
            && (!causal || k0 + BN - 1 <= q0)
            && (window <= 0 || k0 > q_last - window);
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = sc[4 * j + e] * scale;
                if (!full_tile) {
                    const int qi = row0 + (e >> 1) * 8;
                    const int key = k0 + 8 * j + 2 * tig + (e & 1);
                    const bool masked = (causal && key > qi)
                        || (window > 0 && key <= qi - window);
                    x = key >= t_len ? -INFINITY : (masked ? NEG : x);
                }
                sc[4 * j + e] = x;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float t = tmax[r];
            t = fmaxf(t, __shfl_xor_sync(FULL, t, 1));
            t = fmaxf(t, __shfl_xor_sync(FULL, t, 2));
            const float m_new = fmaxf(m_r[r], t);
            alpha[r] = expf(m_r[r] - m_new);
            m_r[r] = m_new;
            l_r[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            sc[j] = expf(sc[j] - m_r[(j >> 1) & 1]);
            l_r[(j >> 1) & 1] += sc[j];
        }
    };

    // p split into bf16 hi / lo A fragments: k16 chunk c takes registers
    // 4 c .. 4 c + 3 (rows gid, gid + 8 of keys 16 c + 2 tig, then of keys
    // 16 c + 8 + 2 tig)
    auto split = [&](const float (&sc)[32], uint32_t (&ph)[16],
                     uint32_t (&pl)[16]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int base = 4 * (j / 2) + 2 * (j % 2);
            split_pack(sc[4 * j], sc[4 * j + 1], ph[base], pl[base]);
            split_pack(sc[4 * j + 2], sc[4 * j + 3], ph[base + 1],
                       pl[base + 1]);
        }
    };

    // Tile i's P V runs on the tensor cores together with tile i + 1's
    // q k^T and under tile i + 1's softmax; o is rescaled only once both
    // are waited for (a write to an accumulator while a wgmma is in flight
    // would make the compiler serialize them).
    float sc[32];
    uint32_t ph[16], pl[16];
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    mbar_wait<true>(&q_bar, 0);
    if (n_tiles > 0) {
        issue_qk(sc, 0);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(sc, 0, alpha);                      // o is 0: no rescale
        split(sc, ph, pl);
    }
    // (the last tile is peeled off: a wait under a condition that the
    // compiler cannot tie to the issue also makes it serialize)
    for (int i = 0; i + 1 < n_tiles; ++i) {
        issue_qk(sc, i + 1);
        issue_pv(i, ph, pl);
        wgmma_wait<1>();                            // tile i + 1's q k^T
        fence_regs(sc);
        softmax(sc, i + 1, alpha);
        wgmma_wait<0>();                            // tile i's P V
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(o[p]);
        fence_regs(ph);
        fence_regs(pl);
        mbar_arrive(&empty_bar[i % STAGES]);        // the stage is free
        split(sc, ph, pl);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int e = 0; e < 32; ++e) o[p][e] *= alpha[(e >> 1) & 1];
    }
    if (n_tiles > 0) {
        issue_pv(n_tiles - 1, ph, pl);
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    }

    // out = o / max(l, 1e-30), the row's l summed over its four lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(FULL, l, 1);
        l += __shfl_xor_sync(FULL, l, 2);
        l_r[r] = fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qi = row0 + 8 * r;
        if (qi >= s_len) continue;
        __nv_bfloat16* orow =
            out + (static_cast<int64_t>(head) * s_len + qi) * d;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = p * PANEL + 8 * j + 2 * tig;
                if (col < d)                        // d is even: col + 1 too
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                        __floats2bfloat162_rn(o[p][4 * j + 2 * r] / l_r[r],
                                              o[p][4 * j + 2 * r + 1]
                                                  / l_r[r]);
            }
    }
}

#undef FA_D32
#undef FA_OUT32

// ---- host side ------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver entry point; it is fetched through the
// runtime (cudaGetDriverEntryPoint*), so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
        if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// (groups, rows, d) bf16, row-major, as a 3-d map with (64, box_rows, 1)
// boxes, the 128-byte swizzle and zeros outside the tensor
bool make_map(CUtensorMap* map, const void* ptr, int groups, int rows, int d,
              int box_rows) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(groups)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                   static_cast<cuuint64_t>(d) * rows * 2};
    const cuuint32_t box[3] = {PANEL, static_cast<cuuint32_t>(box_rows), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
               const_cast<void*>(ptr), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* out, int gkv, int n_rep, int s,
           int t, int d, int causal, int window, float div,
           cudaStream_t st) {
    const size_t smem = static_cast<size_t>(NC) * BM * DP * 2
        + 2 * static_cast<size_t>(STAGES) * BN * DP * 2 + 1024;
    if constexpr (NC == 2) {
        // setmaxnreg.inc waits for registers that the block does not hold
        // unless ptxas gave every thread the launch bound's maximum: refuse
        // such a build rather than hang
        cudaFuncAttributes attr;
        cudaError_t e = cudaFuncGetAttributes(&attr,
                                              flash_attn_wgmma_kernel<DP, NC>);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (attr.numRegs * block_threads<NC>()
            < (NC * CONSUMER_REGS + PRODUCER_REGS) * WG)
            return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_wgmma_kernel<DP, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = static_cast<int64_t>((s + BM - 1) / BM) * gkv
        * ((n_rep + NC - 1) / NC);
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    flash_attn_wgmma_kernel<DP, NC>
        <<<static_cast<unsigned>(blocks), block_threads<NC>(), smem, st>>>(
            tq, tk, tv, static_cast<__nv_bfloat16*>(out), gkv, n_rep, s, t,
            d, causal, window, div);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (G, S, D), k and v (Gkv, T, D), out (G, S, D), all bfloat16, contiguous
// and 16-byte aligned; D a multiple of 8 (TMA's row stride), at most 256;
// window 0 = none. Returns a cudaError_t.
extern "C" int repro_flash_attn_wgmma(
        const void* q, const void* k, const void* v, int g, int gkv, int s,
        int t, int d, int causal, int window, float div, void* out,
        void* stream) {
    if (g <= 0 || s <= 0) return 0;
    if (gkv < 1 || g % gkv || t < 1 || d < 8 || d > 256 || d % 8
        || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
         | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out))
        % 16)
        return static_cast<int>(cudaErrorMisalignedAddress);
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, g, s, d, BM) || !make_map(&tk, k, gkv, t, d, BN)
        || !make_map(&tv, v, gkv, t, d, BN))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_rep = g / gkv;
    const int dp = (d + PANEL - 1) / PANEL * PANEL;
    // two consumer warpgroups share a block where two query groups share a
    // kv group and the accumulator fits beside them (DP <= 128)
    const bool two = n_rep >= 2 && dp <= 128;
#define FA_LAUNCH(DP_, NC_)                                                  \
    launch<DP_, NC_>(tq, tk, tv, out, gkv, n_rep, s, t, d, causal, window,   \
                     div, st)
    switch (dp) {
        case 64: return two ? FA_LAUNCH(64, 2) : FA_LAUNCH(64, 1);
        case 128: return two ? FA_LAUNCH(128, 2) : FA_LAUNCH(128, 1);
        case 192: return FA_LAUNCH(192, 1);
        default: return FA_LAUNCH(256, 1);
    }
#undef FA_LAUNCH
}
