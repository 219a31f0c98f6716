// The float tail of the GB-KMV containment estimate of one (record X,
// query Q) pair, shared by the dense sweep (gbkmv_score.cu, B1) and the
// candidate verify (gather_score.cu, B5) so that the two kernels cannot
// drift apart, as the reference's two Pallas kernels share one math.
//
//   τ = min(thr_X, thr_Q); n_x, n_q = #values ≤ τ;
//   K∩ = #live X values present in Q; k = n_x + n_q − K∩;
//   U = largest live value of either row;
//   D̂∩ = (K∩ / max(k,1)) · ((k−1) / max((U+1)/2^32, 1e-30))   (Eq. 25)
//        when k ≥ 2 and K∩ ≥ 1, else K∩ (or 0);
//   o1 = popcount(buf_X & buf_Q);   score = (o1 + D̂∩) / max(|Q|, 1).
//
// gbkmv_pair_tail takes the integer counts: each kernel finds n_x, n_q, K∩,
// U and o1 its own way (counts are exact under any method) and ends in this
// one function. With K∩ = 0 it reads o1 and |Q| only.
//
// The float tail repeats the reference's operation order with explicit
// round-to-nearest intrinsics (and the library builds with -fmad=false): a
// score is compared with `score >= t`, so one ulp flips an answer.

#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ float gbkmv_pair_tail(int nx, int nq, int kcap,
                                                uint32_t u, int o1,
                                                int32_t q_size) {
  const int k = nx + nq - kcap;
  const float u_unit =
      __fdiv_rn(__fadd_rn(__uint2float_rn(u), 1.0f), 4294967296.0f);
  const float kf = __int2float_rn(k);
  const float cf = __int2float_rn(kcap);
  float d;
  if (k >= 2 && kcap >= 1) {
    d = __fmul_rn(__fdiv_rn(cf, fmaxf(kf, 1.0f)),
                  __fdiv_rn(__fsub_rn(kf, 1.0f), fmaxf(u_unit, 1e-30f)));
  } else {
    d = kcap >= 1 ? cf : 0.0f;
  }
  const float qsf = fmaxf(__int2float_rn(q_size), 1.0f);
  return __fdiv_rn(__fadd_rn(__int2float_rn(o1), d), qsf);
}

}  // namespace repro
