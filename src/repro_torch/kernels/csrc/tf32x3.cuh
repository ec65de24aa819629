// fp32-grade matrix products on Hopper's tensor cores, shared by
// gru_tile.cuh (gru_cell.cu, memory_update.cu), embed_attn.cu and
// ssd_chunk.cu.
//
// The tensor cores take fp32 operands only as TF32 (10 mantissa bits).
// Rounding each operand once misses fp32 parity by about 1e-3 at the
// port's widths, so every operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and a product a b is the sum of three TF32 products
// (a_lo b_hi + a_hi b_lo + a_hi b_hi, the smallest first) accumulated in
// fp32: the "3xTF32" scheme, within about 1e-6 of an fp32 product. The
// product is mma.sync m16n8k8 (.tf32 operands, .f32 accumulators), one
// warp a 16 x 8 tile.
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major)  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k-major)     b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8)             c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t)
//                          c3 (g + 8, 2t + 1)
// An A tile in shared memory with a row stride of 4 mod 8 floats and a B
// tile with a row stride of 8 or 24 mod 32 floats are read without bank
// conflicts (tf32_ld rounds a width up to such a stride).
//
// Operand tiles reach shared memory by cp.async (16-byte copies where the
// widths and pointers allow, else 4-byte ones; zero-filled outside the
// matrix), so a block can stage its next depth chunk while it multiplies
// the current one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// row stride (floats) of a shared A tile `width` wide: width rounded up to
// 8, plus 4 (4 mod 8: the A fragment's 32 reads hit 32 banks)
__host__ __device__ __forceinline__ int tf32_ld(int width) {
    return ((width + 7) & ~7) + 4;
}

struct Tf32x2 {
    uint32_t hi, lo;
};

// x = hi + lo, each rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest,
// ties away from zero, on sign and magnitude), by integer operations: nvcc
// emulates cvt.rna on sm_90 with an inf/NaN test and a select around
// (bits + 0x1000) & ~0x1fff, and that sum alone is the same rounding for
// every finite x. The tensor core reads only an operand's 19 high bits, so
// hi and lo go to it unmasked and only the hi that x - hi subtracts is
// masked: four instructions where cvt.rna takes eight. Infinities and NaNs
// give the products cvt.rna's split gives (hi inf, lo NaN).
__device__ __forceinline__ Tf32x2 tf32_split(float x) {
    const uint32_t hi = __float_as_uint(x) + 0x1000u;
    const float rest = x - __uint_as_float(hi & 0xffffe000u);
    return {hi, __float_as_uint(rest) + 0x1000u};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one 16 x 8 x 8 step of A and B, both split (see the note above)
struct FragA {
    uint32_t hi[4], lo[4];
};
struct FragB {
    uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
}

// the A fragment of four split elements: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) of the 16 x 8 tile
__device__ __forceinline__ FragA frag_a(float v0, float v1, float v2,
                                        float v3) {
    const float v[4] = {v0, v1, v2, v3};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const Tf32x2 s = tf32_split(v[i]);
        f.hi[i] = s.hi;
        f.lo[i] = s.lo;
    }
    return f;
}

// A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a row-major
// shared tile (row stride lda); with MASK, columns at or past kd read as 0
template <bool MASK = true>
__device__ __forceinline__ FragA load_frag_a(const float* as, int lda, int r0,
                                             int k0, int kd) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = as + (r0 + g) * lda + k0 + t;
    const bool lo_ok = !MASK || k0 + t < kd, hi_ok = !MASK || k0 + t + 4 < kd;
    return frag_a(lo_ok ? p[0] : 0.0f, lo_ok ? p[8 * lda] : 0.0f,
                       hi_ok ? p[4] : 0.0f, hi_ok ? p[8 * lda + 4] : 0.0f);
}

// the A fragment of columns k0 .. k0 + 7 whose rows g and g + 8 sit at
// offsets off0 and off8 of a shared tile (any rows: repeated ones too)
__device__ __forceinline__ FragA load_frag_a_rows(const float* as, int off0,
                                                  int off8, int k0) {
    const int t = threadIdx.x & 3;
    const float* p0 = as + off0 + k0 + t;
    const float* p8 = as + off8 + k0 + t;
    return frag_a(p0[0], p8[0], p0[4], p8[4]);
}

// the B fragment of two split elements: depth rows k0 + t and k0 + t + 4
__device__ __forceinline__ FragB frag_b(float v0, float v4) {
    const Tf32x2 s0 = tf32_split(v0);
    const Tf32x2 s1 = tf32_split(v4);
    return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// B fragment of depth rows k0 .. k0 + 7, columns n0 .. n0 + 7 of a k-major
// shared tile (row stride ldb)
__device__ __forceinline__ FragB load_frag_b(const float* bs, int ldb, int k0,
                                             int n0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = bs + (k0 + t) * ldb + n0 + g;
    return frag_b(p[0], p[4 * ldb]);
}

// the same fragment from an n-major shared tile (row stride ldn, 4 mod 8)
__device__ __forceinline__ FragB load_frag_b_nmajor(const float* bs, int ldn,
                                                    int k0, int n0) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float* p = bs + (n0 + g) * ldn + k0 + t;
    return frag_b(p[0], p[4]);
}

// dst <- *src when ok, else 0 (src is then not read; `any` is a valid
// address to name instead)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok, const float* any) {
    const uint32_t d =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(ok ? src : any), "r"(ok ? 4 : 0)
                 : "memory");
}

// dst[0..3] <- the first `bytes` (0, 4, 8, 12 or 16) of src[0..3], the
// rest zero; dst and, when bytes > 0, src 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes, const float* any) {
    const uint32_t d =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(bytes > 0 ? src : any), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace
