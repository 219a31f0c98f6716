// Warp- and CTA-wide inclusive scans: the postings probe (B3) scans the
// block-task prefix over its CTA, the block decode (B4) its delta sums and
// dense-word ranks over a warp.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Inclusive sum of `v` over the warp's lanes; every lane must call it.
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Inclusive sum of `v` over the CTA's threads; every thread must call it.
// The CTA's width is a multiple of 32, at most 1,024; `warp_tot` holds one
// word per warp.
__device__ uint32_t cta_inclusive_scan(uint32_t v, uint32_t* warp_tot) {
  const int warp = threadIdx.x >> 5;
  v = warp_inclusive_scan(v);
  if ((threadIdx.x & 31) == 31) warp_tot[warp] = v;
  __syncthreads();
  uint32_t add = 0;
  for (int w = 0; w < warp; ++w) add += warp_tot[w];
  __syncthreads();  // warp_tot may be written again by the next scan
  return v + add;
}

}  // namespace
