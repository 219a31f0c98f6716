// Ragged candidate verify: the GB-KMV containment score of each
// (record, query) pair of a candidate list.
//
// Replaces the Pallas kernel `_pair_kernel` of
// src/repro/kernels/gather_score.py (B5), which takes one pair per grid
// step and has the two rows DMA'd in through scalar-prefetched index maps.
// The per-pair math is the dense kernel's (repro::gbkmv_pair_score in
// gbkmv_pair.cuh), so a candidate scores exactly what the dense sweep gives
// the same pair.
//
// Bound on the H100: memory, and latency in practice. Per pair the kernel
// reads cand_rec and cand_q, the record row up to its first value above
// τ_pair, the two thresholds, the buffers and the query size, and writes
// one f32; the integer merge is O(n_x + n_q) compares. The record rows are
// scattered (candidates of one query ascend by record id), so each pair
// touches its own 32-byte sectors.
//
// Design: one thread per pair, grid-stride. A thread reads its two indices
// and walks the two sorted rows in place, in device memory: no gathered
// copy of the rows is made. Neighbouring threads usually share a query, so
// the query row is served from L1. An index out of range writes NaN rather
// than reading outside the columns; the wrapper's callers pass indices in
// range.

#include <cstdint>
#include <cuda_runtime.h>

#include "gbkmv_pair.cuh"

namespace {

__global__ void gather_score_kernel(
    const uint32_t* __restrict__ xv, const uint32_t* __restrict__ xt,
    const uint32_t* __restrict__ xb, int64_t m, int c, int w,
    const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qt,
    const uint32_t* __restrict__ qb, const int32_t* __restrict__ qs, int gq,
    int cq, const int32_t* __restrict__ cand_rec,
    const int32_t* __restrict__ cand_q, int64_t p, float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < p;
       i += stride) {
    const int64_t r = cand_rec[i];
    const int g = cand_q[i];
    if (r < 0 || r >= m || g < 0 || g >= gq) {
      out[i] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    out[i] = repro::gbkmv_pair_score(xv + r * c, c, xt[r], xb + r * w,
                                     qv + (int64_t)g * cq, cq, qt[g],
                                     qb + (int64_t)g * w, w, qs[g]);
  }
}

}  // namespace

// x*: u32 values [m, c], thresholds [m], buffers [m, w]; q*: values [gq, cq],
// thresholds [gq], buffers [gq, w], sizes i32 [gq]; cand_rec, cand_q:
// i32 [p]; out: f32 [p]. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gather_score_launch(const void* xv, const void* xt,
                                   const void* xb, int64_t m, int c, int w,
                                   const void* qv, const void* qt,
                                   const void* qb, const void* qs, int gq,
                                   int cq, const void* cand_rec,
                                   const void* cand_q, int64_t p, void* out,
                                   void* stream) {
  const int threads = 256;
  int64_t blocks = (p + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gather_score_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)xv, (const uint32_t*)xt, (const uint32_t*)xb, m, c, w,
      (const uint32_t*)qv, (const uint32_t*)qt, (const uint32_t*)qb,
      (const int32_t*)qs, gq, cq, (const int32_t*)cand_rec,
      (const int32_t*)cand_q, p, (float*)out);
  return (int)cudaGetLastError();
}
