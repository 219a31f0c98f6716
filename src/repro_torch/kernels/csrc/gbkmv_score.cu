// Dense GB-KMV containment scores of a query batch against every record.
//
// Replaces the Pallas kernel `_score_kernel` of
// src/repro/kernels/gbkmv_score.py (B1). For each (record X, query Q):
//   τ = min(thr_X, thr_Q); n_x, n_q = #values ≤ τ;
//   K∩ = #live X values present in Q; k = n_x + n_q − K∩;
//   U = largest live value of either row;
//   D̂∩ = (K∩ / max(k,1)) · ((k−1) / max((U+1)/2^32, 1e-30))   (Eq. 25)
//        when k ≥ 2 and K∩ ≥ 1, else K∩ (or 0);
//   o1 = popcount(buf_X & buf_Q);   score = (o1 + D̂∩) / max(|Q|, 1).
//
// Bound on the H100: memory. Each record row is read up to its first value
// above τ (not its padded width), its threshold and buffer once, and the
// f32[M, Gq] matrix written once; the per-pair work is O(n_x + n_q) integer
// compares, far under the card's operation rate.
//
// Design: the TPU kernel broadcasts equality over 128-lane query chunks,
// the natural form of a vector unit. Here each thread takes one pair and
// walks the two sorted rows: n_x and n_q are the live prefixes, K∩ is a
// two-pointer merge of them (rows are sorted ascending, so the count equals
// the reference's equality count), U is the larger last live value, o1 is
// `__popc` over the buffer words. The query pack (values, thresholds,
// buffers, sizes) is staged in shared memory once per block; threads of a
// warp walk consecutive queries of the same record, so the record row is
// read by a broadcast and the output row is written coalesced.
//
// The float tail repeats the reference's operation order with explicit
// round-to-nearest intrinsics (and the file is built with -fmad=false):
// a score is compared with `score >= t`, so one ulp flips an answer.

#include <cstdint>
#include <cuda_runtime.h>

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
    const uint32_t* x = xv + r * c;
    const uint32_t* q = s_qv + g * cq;
    const uint32_t tau = min(xt[r], s_qt[g]);

    int nx = 0;
    while (nx < c && x[nx] <= tau) ++nx;
    int nq = 0;
    while (nq < cq && q[nq] <= tau) ++nq;

    // K∩: each live x value that occurs in the live query prefix. The
    // query pointer does not advance on a match, so equal values count
    // exactly as the reference's equality broadcast counts them.
    int kcap = 0;
    int j = 0;
    for (int i = 0; i < nx; ++i) {
      const uint32_t v = x[i];
      while (j < nq && q[j] < v) ++j;
      if (j == nq) break;
      if (q[j] == v) ++kcap;
    }
    const int k = nx + nq - kcap;
    const uint32_t ux = nx > 0 ? x[nx - 1] : 0u;
    const uint32_t uq = nq > 0 ? q[nq - 1] : 0u;
    const uint32_t u = ux > uq ? ux : uq;

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

    int o1 = 0;
    const uint32_t* xbr = xb + r * w;
    const uint32_t* qbr = s_qb + g * w;
    for (int t = 0; t < w; ++t) o1 += __popc(xbr[t] & qbr[t]);

    const float qsf = fmaxf(__int2float_rn(s_qs[g]), 1.0f);
    out[p] = __fdiv_rn(__fadd_rn(__int2float_rn(o1), d), qsf);
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
