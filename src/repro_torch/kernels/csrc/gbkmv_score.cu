// Dense GB-KMV containment scores of a query batch against every record.
//
// Replaces the Pallas kernel `_score_kernel` of
// src/repro/kernels/gbkmv_score.py (B1). The per-pair math (τ_pair, live
// counts, K∩, the Eq. 25 tail, the buffer popcount) is
// repro::gbkmv_pair_score in gbkmv_pair.cuh, shared with the candidate
// verify kernel (B5).
//
// Bound on the H100: memory. Each record row is read up to its first value
// above τ (not its padded width), its threshold and buffer once, and the
// f32[M, Gq] matrix written once; the per-pair work is O(n_x + n_q) integer
// compares, far under the card's operation rate.
//
// Design: the TPU kernel broadcasts equality over 128-lane query chunks,
// the natural form of a vector unit. Here each thread takes one pair and
// walks the two sorted rows (gbkmv_pair.cuh). The query pack (values,
// thresholds, buffers, sizes) is staged in shared memory once per block;
// threads of a warp walk consecutive queries of the same record, so the
// record row is read by a broadcast and the output row is written
// coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "gbkmv_pair.cuh"

namespace {

__global__ void gbkmv_score_kernel(
    const uint32_t* __restrict__ xv, const uint32_t* __restrict__ xt,
    const uint32_t* __restrict__ xb, int64_t m, int c, int w,
    const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qt,
    const uint32_t* __restrict__ qb, const int32_t* __restrict__ qs, int gq,
    int cq, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_qv = smem;                                   // [gq, cq]
  uint32_t* s_qt = s_qv + (int64_t)gq * cq;                // [gq]
  uint32_t* s_qb = s_qt + gq;                              // [gq, w]
  int32_t* s_qs = reinterpret_cast<int32_t*>(s_qb + gq * w);  // [gq]
  for (int i = threadIdx.x; i < gq * cq; i += blockDim.x) s_qv[i] = qv[i];
  for (int i = threadIdx.x; i < gq * w; i += blockDim.x) s_qb[i] = qb[i];
  for (int i = threadIdx.x; i < gq; i += blockDim.x) {
    s_qt[i] = qt[i];
    s_qs[i] = qs[i];
  }
  __syncthreads();

  const int64_t total = m * gq;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < total;
       p += stride) {
    const int64_t r = p / gq;
    const int g = (int)(p - r * gq);
    out[p] = repro::gbkmv_pair_score(xv + r * c, c, xt[r], xb + r * w,
                                     s_qv + g * cq, cq, s_qt[g],
                                     s_qb + g * w, w, s_qs[g]);
  }
}

}  // namespace

// x*: u32 values [m, c], thresholds [m], buffers [m, w]; q*: values [gq, cq],
// thresholds [gq], buffers [gq, w], sizes i32 [gq]; out: f32 [m, gq]
// row-major. Launches on `stream` and returns cudaGetLastError().
extern "C" int gbkmv_score_launch(const void* xv, const void* xt,
                                  const void* xb, int64_t m, int c, int w,
                                  const void* qv, const void* qt,
                                  const void* qb, const void* qs, int gq,
                                  int cq, void* out, void* stream) {
  // The staged query pack: values, thresholds, buffers, sizes.
  const int64_t smem = ((int64_t)gq * cq + gq + (int64_t)gq * w + gq) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gbkmv_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  int64_t blocks = (m * gq + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  gbkmv_score_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)xv, (const uint32_t*)xt, (const uint32_t*)xb, m, c, w,
      (const uint32_t*)qv, (const uint32_t*)qt, (const uint32_t*)qb,
      (const int32_t*)qs, gq, cq, (float*)out);
  return (int)cudaGetLastError();
}
