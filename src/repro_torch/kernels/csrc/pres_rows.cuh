// PRES filter element body (Eq. 7 predict -> Eq. 8 correct -> Eq. 9 delta
// rate) shared by pres_filter.cu and memory_update.cu.
//
// For one element of an occurrence row, with sc the row's Eq. 7 scale:
//   s_pred = s_prev + clip(sc * dmean, -clip, clip)
//   fused  = (1 - gamma) * s_pred + gamma * s_meas
//   delta  = (fused - base) / max(sc, 1), base = s_pred (innovation) or
//            s_prev (transition)
// Every product, sum and the quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn): nvcc would otherwise contract
// a * b + c into one FMA, and the plain PyTorch version, which runs each
// operation as a kernel of its own, rounds every step. So the filter
// equals its plain version bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

// one_minus_gamma = __fsub_rn(1.0f, gamma), formed once by the caller.
__device__ __forceinline__ void pres_filter_elem(
        float s_prev, float s_meas, float dmean, float sc, float gamma,
        float one_minus_gamma, float clip, int innovation, float& fused,
        float& delta) {
    const float step = fminf(fmaxf(__fmul_rn(sc, dmean), -clip), clip);
    const float s_pred = __fadd_rn(s_prev, step);
    fused = __fadd_rn(__fmul_rn(one_minus_gamma, s_pred),
                      __fmul_rn(gamma, s_meas));
    const float base = innovation ? s_pred : s_prev;
    delta = __fdiv_rn(__fsub_rn(fused, base), fmaxf(sc, 1.0f));
}

}  // namespace
