// CTA-wide inclusive scan, shared by the postings probe (B3: the block-task
// prefix) and the block decode (B4: delta sums and dense-word ranks).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Inclusive sum of `v` over the CTA's threads; every thread must call it.
// The CTA's width is a multiple of 32, at most 1,024; `warp_tot` holds one
// word per warp.
__device__ uint32_t cta_inclusive_scan(uint32_t v, uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  uint32_t add = 0;
  for (int w = 0; w < warp; ++w) add += warp_tot[w];
  __syncthreads();  // warp_tot may be written again by the next scan
  return v + add;
}

}  // namespace
