// Dense GB-KMV containment scores of a query batch against every record.
//
// Replaces the Pallas kernel `_score_kernel` of
// src/repro/kernels/gbkmv_score.py (B1). The float tail (the Eq. 25
// estimate, the buffer term, the division by |Q|) is repro::gbkmv_pair_tail
// in gbkmv_pair.cuh, shared with the candidate verify kernel (B5).
//
// Bound on the H100, as measured (PERF.md §6, tools/score_variants.py,
// NVIDIA H100 80GB HBM3 at the NETFLIX deployment, bare launches): neither
// the bytes nor the operations. The bytes the function must move give
// 0.015 ms and storing the f32[M, Gq] output alone takes 0.009, but a
// record row is read in whole DRAM bursts, so a body that only reads each
// record's first row sector, threshold and buffer word and stores its
// scores as if K∩ were 0 takes 0.029. One thread per (record, query)
// pair, walking both rows for the live counts, K∩ and the largest live
// value, took 0.093: that per-pair walk, issued for every pair while K∩ ≥
// 1 holds for under 1 % of them, is what cost. This body takes 0.051; a
// body without the candidates' re-score took 0.043.
//
// Design:
//   - One thread per record (a CTA of 256 records). It loads the record's
//     threshold, first buffer word and first 32-B row sector (8 values) up
//     front, in two 16-B loads where the rows allow, and counts its live
//     prefix once.
//   - The query pack sits in shared memory with each query's own live count
//     and largest live value. A filter of 2,048 words holds bit g & 31 at
//     v & 2047 for every value v of query g's live prefix. A record ORs the
//     words of its live values: where query g's bit is clear, no live record
//     value is in the query, so K∩ = 0 exactly, and the score is the tail of
//     the buffer term alone.
//   - So every pair is first scored as K∩ = 0, branch-free, and the record's
//     row of Gq scores written (in 16-B stores where Gq is a multiple of
//     4; scalar head loads took 5 % longer and scalar stores 37 % on the
//     H100 at the NETFLIX deployment). Then the queries whose bit is set
//     (and every 32nd query after each) are scored again exactly, out of
//     line, from the counts the record already holds, and overwrite
//     theirs.
//   - 32-bit record and query indices; no division by a runtime count.

#include <cstdint>
#include <cuda_runtime.h>

#include "gbkmv_pair.cuh"
#include "launch_util.cuh"

namespace {

constexpr int kThreads = 256;    // records per CTA, one thread each
constexpr int kHead = 8;         // row values held in registers: one sector
constexpr int kFilter = 2048;    // filter words (static shared memory)
constexpr uint32_t kPad = 0xFFFFFFFFu;
// Shared memory one block may use on Hopper; the query pack may take what
// the filter leaves (opted in above 48 KB).
constexpr int kMaxSmem = 232448;
constexpr int kMaxPackSmem = kMaxSmem - kFilter * 4;

// #values ≤ v in the ascending row[0, n).
__device__ __forceinline__ int upper_bound(const uint32_t* row, int n,
                                           uint32_t v) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (row[lo + half] <= v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// A record row: its first kHead values in registers (PAD past c), the rest
// read from device memory. Loops over the head are unrolled, so the values
// stay in registers.
struct Row {
  uint32_t h[kHead];
  const uint32_t* x;
  int c;

  // #values ≤ tau (the row is sorted).
  __device__ __forceinline__ int count_le(uint32_t tau) const {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kHead; ++i) n += (i < c) & (h[i] <= tau);
    if (n == kHead) {
      while (n < c && x[n] <= tau) ++n;
    }
    return n;
  }
  // The n-th value (n ≥ 1), 0 for n = 0: the largest of a live prefix.
  __device__ __forceinline__ uint32_t last(int n) const {
    uint32_t u = 0;
#pragma unroll
    for (int i = 0; i < kHead; ++i) u = i < n ? h[i] : u;
    return n > kHead ? x[n - 1] : u;
  }
  // #values of the first n present in the ascending q[0, nq): a two-pointer
  // merge whose query pointer does not advance on a match, so repeated
  // values count as the reference's equality broadcast counts them.
  __device__ __forceinline__ int common(int n, const uint32_t* q,
                                        int nq) const {
    int k = 0;
    int j = 0;
#pragma unroll
    for (int i = 0; i < kHead; ++i) {
      if (i < n) {
        const uint32_t v = h[i];
        while (j < nq && q[j] < v) ++j;
        k += (j < nq && q[j] == v);
      }
    }
    for (int i = kHead; i < n; ++i) {
      const uint32_t v = x[i];
      while (j < nq && q[j] < v) ++j;
      k += (j < nq && q[j] == v);
    }
    return k;
  }
};

// The query pack in shared memory.
struct Pack {
  const uint32_t* v;   // [gq, cq] values
  const uint32_t* t;   // [gq] thresholds
  const uint32_t* b;   // [gq, w] buffers
  const int32_t* s;    // [gq] sizes
  const int32_t* nq;   // [gq] own live counts (#values ≤ the threshold)
  const uint32_t* uq;  // [gq] own largest live values (0 if none)
  int gq, cq, w;
};

__device__ __forceinline__ int buffer_common(uint32_t xb0,
                                             const uint32_t* xbr,
                                             const uint32_t* qb, int w) {
  int o1 = w > 0 ? __popc(xb0 & qb[0]) : 0;
  for (int t = 1; t < w; ++t) o1 += __popc(xbr[t] & qb[t]);
  return o1;
}

// The exact score of every query g with bit g & 31 set in `cand`, over the
// K∩ = 0 score already in orow[g]. τ = min(thr, q_thresh): the record's own
// live count serves where its threshold is the smaller, the query's where
// the query's is.
__device__ __noinline__ void rescore(const Row row, uint32_t thr, int nx_rec,
                                     uint32_t xb0, const uint32_t* xbr,
                                     uint32_t cand, const Pack p,
                                     float* orow) {
  const uint32_t ux_rec = row.last(nx_rec);
  for (uint32_t bits = cand; bits; bits &= bits - 1) {
    for (int g = __ffs(bits) - 1; g < p.gq; g += 32) {
      const uint32_t tq = p.t[g];
      const uint32_t* q = p.v + g * p.cq;
      int nx = nx_rec;
      uint32_t ux = ux_rec;
      if (tq < thr) {
        nx = row.count_le(tq);
        ux = row.last(nx);
      }
      int nq = p.nq[g];
      uint32_t uq = p.uq[g];
      if (thr < tq) {
        nq = upper_bound(q, nq, thr);
        uq = nq > 0 ? q[nq - 1] : 0u;
      }
      orow[g] = repro::gbkmv_pair_tail(
          nx, nq, row.common(nx, q, nq), ux > uq ? ux : uq,
          buffer_common(xb0, xbr, p.b + g * p.w, p.w), p.s[g]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gbkmv_score_kernel(
    const uint32_t* __restrict__ xv, const uint32_t* __restrict__ xt,
    const uint32_t* __restrict__ xb, int m, int c, int w, int vec_rows,
    const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qt,
    const uint32_t* __restrict__ qb, const int32_t* __restrict__ qs, int gq,
    int cq, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t s_filter[kFilter];
  uint32_t* s_qv = smem;
  uint32_t* s_qt = s_qv + gq * cq;
  uint32_t* s_qb = s_qt + gq;
  int32_t* s_qs = reinterpret_cast<int32_t*>(s_qb + gq * w);
  int32_t* s_nq = s_qs + gq;
  uint32_t* s_uq = reinterpret_cast<uint32_t*>(s_nq + gq);
  for (int i = threadIdx.x; i < kFilter; i += kThreads) s_filter[i] = 0u;
  for (int i = threadIdx.x; i < gq * cq; i += kThreads) s_qv[i] = qv[i];
  for (int i = threadIdx.x; i < gq * w; i += kThreads) s_qb[i] = qb[i];
  for (int i = threadIdx.x; i < gq; i += kThreads) {
    s_qt[i] = qt[i];
    s_qs[i] = qs[i];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < gq; g += kThreads) {
    const int n = upper_bound(s_qv + g * cq, cq, s_qt[g]);
    s_nq[g] = n;
    s_uq[g] = n > 0 ? s_qv[g * cq + n - 1] : 0u;
  }
  __syncthreads();
  for (int g = threadIdx.x / 32; g < gq; g += kThreads / 32) {
    for (int j = threadIdx.x % 32; j < s_nq[g]; j += 32) {
      atomicOr(&s_filter[s_qv[g * cq + j] & (kFilter - 1)], 1u << (g & 31));
    }
  }
  __syncthreads();

  // Unsigned: the last CTA's index may pass INT32_MAX when m is near it.
  const unsigned r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= (unsigned)m) return;
  Row row;
  row.x = xv + (size_t)r * c;
  row.c = c;
  if (vec_rows) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row.x));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row.x) + 1);
    row.h[0] = a.x; row.h[1] = a.y; row.h[2] = a.z; row.h[3] = a.w;
    row.h[4] = b.x; row.h[5] = b.y; row.h[6] = b.z; row.h[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kHead; ++i) row.h[i] = i < c ? row.x[i] : kPad;
  }
  const uint32_t thr = xt[r];
  const uint32_t* xbr = xb + (size_t)r * w;
  const uint32_t xb0 = w > 0 ? xbr[0] : 0u;
  const int nx_rec = row.count_le(thr);
  uint32_t hits = 0;
#pragma unroll
  for (int i = 0; i < kHead; ++i) {
    if (i < nx_rec) hits |= s_filter[row.h[i] & (kFilter - 1)];
  }
  for (int i = kHead; i < nx_rec; ++i) {
    hits |= s_filter[row.x[i] & (kFilter - 1)];
  }

  // Every pair as K∩ = 0 (the tail then reads o1 and |Q| only).
  float* orow = out + (size_t)r * gq;
  const bool vec_out = (gq & 3) == 0;
  for (int g = 0; g < gq; g += 4) {
    float s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int gk = min(g + k, gq - 1);
      s[k] = repro::gbkmv_pair_tail(
          0, 0, 0, 0u, buffer_common(xb0, xbr, s_qb + gk * w, w), s_qs[gk]);
    }
    if (vec_out) {
      *reinterpret_cast<float4*>(orow + g) =
          make_float4(s[0], s[1], s[2], s[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (g + k < gq) orow[g + k] = s[k];
      }
    }
  }

  const uint32_t cand = gq >= 32 ? hits : hits & ((1u << gq) - 1u);
  if (cand) {
    rescore(row, thr, nx_rec, xb0, xbr, cand,
            Pack{s_qv, s_qt, s_qb, s_qs, s_nq, s_uq, gq, cq, w}, orow);
  }
}

}  // namespace

// Shared memory a launch stages for a [gq, cq] query pack with w buffer
// words: values, buffers, and per query its threshold, size, own live
// count and largest live value.
extern "C" int64_t gbkmv_score_pack_bytes(int gq, int cq, int w) {
  return ((int64_t)gq * cq + (int64_t)gq * w + 4 * (int64_t)gq) * 4;
}

// The most a launch may stage for its query pack.
extern "C" int64_t gbkmv_score_max_pack_bytes() { return kMaxPackSmem; }

// x*: u32 values [m, c], thresholds [m], buffers [m, w]; q*: values [gq, cq],
// thresholds [gq], buffers [gq, w], sizes i32 [gq]; out: f32 [m, gq]
// row-major. Launches on `stream` of card `device` (made current for the
// call) and returns a CUDA error code; m = 0 or gq = 0 launches nothing. The
// pack's gbkmv_score_pack_bytes must be at most gbkmv_score_max_pack_bytes.
extern "C" int gbkmv_score_launch(const void* xv, const void* xt,
                                  const void* xb, int64_t m, int c, int w,
                                  const void* qv, const void* qt,
                                  const void* qb, const void* qs, int gq,
                                  int cq, void* out, int device,
                                  void* stream) {
  const int64_t smem = gbkmv_score_pack_bytes(gq, cq, w);
  if (m < 0 || m > INT32_MAX || c < 0 || w < 0 || gq < 0 || cq < 0 ||
      smem > kMaxPackSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0 || gq == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  static std::atomic<uint64_t> ready{0};
  const cudaError_t err = raise_smem_limit((const void*)gbkmv_score_kernel,
                                           kMaxPackSmem, ready);
  if (err != cudaSuccess) return (int)err;
  const int vec_rows = c % 4 == 0 && c >= kHead &&
                       reinterpret_cast<uintptr_t>(xv) % 16 == 0;
  gbkmv_score_kernel<<<(unsigned)((m + kThreads - 1) / kThreads), kThreads,
                       (size_t)smem, (cudaStream_t)stream>>>(
      (const uint32_t*)xv, (const uint32_t*)xt, (const uint32_t*)xb, (int)m,
      c, w, vec_rows, (const uint32_t*)qv, (const uint32_t*)qt,
      (const uint32_t*)qb, (const int32_t*)qs, gq, cq, (float*)out);
  return (int)cudaGetLastError();
}
