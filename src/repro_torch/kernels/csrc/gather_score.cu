// Ragged candidate verify: the GB-KMV containment score of each
// (record, query) pair of a candidate list.
//
// Replaces the Pallas kernel `_pair_kernel` of
// src/repro/kernels/gather_score.py (B5), which takes one pair per grid
// step and has the two rows DMA'd in through scalar-prefetched index maps.
// The float tail is the dense kernel's (repro::gbkmv_pair_tail in
// gbkmv_pair.cuh), so a candidate scores exactly what the dense sweep gives
// the same pair.
//
// Bound on the H100: memory in principle, instruction issue in practice.
// Per pair the function must read cand_rec and cand_q, the record row up to
// its first value above τ_pair, the record's threshold and buffer, and
// write one f32; the query pack is read once. The rows are scattered (the
// candidates of one query ascend by record id, a top-k list is in bound
// order), so each pair touches its own sectors. But the per-pair work, two
// or more binary searches and the float tail's three IEEE divisions, is
// issued once for every set of pairs a warp holds, so what a warp costs
// grows with the lanes it spends on a pair. On an H100 at the NETFLIX
// deployment (rows live for one or two values) 2 lanes a pair was the
// fastest group tried, and it is still a few per cent slower than the
// one-thread-per-pair kernel it replaced (PERF.md §6, measured with
// tools/gather_score_variants.py).
//
// Design:
//   - A lane group of kGroup = 2 lanes per pair: a warp holds 16 pairs, a
//     CTA of 256 threads 128, and the grid has one CTA per 128 pairs.
//   - The group reads the record row in steps of one 32-B sector, two 16-B
//     vectors (coalesced uint4 loads when c % 4 == 0 and the column is 16-B
//     aligned; one 4-B value a lane otherwise), and stops after the step in
//     which some value exceeds τ (the rows are sorted; `__ballot_sync` over
//     the group). n_x and K∩ are group sums of the lanes' counts, U_x the
//     group maximum of the live values.
//   - K∩ and n_q come from binary searches over the query row: each live
//     record value is looked up in the row's live prefix [0, n_q), and n_q is
//     the row's upper bound of τ. Counts are integers, so they equal the
//     reference's equality broadcast for any method.
//   - The query rows are read from device memory, where the pairs that
//     share a query find them in L1. Staging the query pack in shared
//     memory per CTA was tried and gained nothing.
//
// An index out of range writes NaN rather than reading outside the
// columns; the wrapper's callers pass indices in range.

#include <cstdint>
#include <cuda_runtime.h>

#include "gbkmv_pair.cuh"
#include "launch_util.cuh"

namespace {

constexpr int kGroup = 2;
static_assert(kGroup >= 2 && (kGroup & (kGroup - 1)) == 0 && kGroup <= 16,
              "the first row step takes two lanes");
constexpr unsigned kGroupMask = (1u << kGroup) - 1;
constexpr int kThreads = 256;
constexpr int kPairsPerBlock = kThreads / kGroup;

__device__ __forceinline__ int group_sum(unsigned mask, int v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(mask, v, o, kGroup);
  }
  return v;
}

__device__ __forceinline__ uint32_t group_max(unsigned mask, uint32_t v) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    v = max(v, __shfl_xor_sync(mask, v, o, kGroup));
  }
  return v;
}

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

// Whether v occurs in the ascending row[0, n).
__device__ __forceinline__ int member(const uint32_t* row, int n,
                                      uint32_t v) {
  int lo = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (row[lo + half] < v) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo < n && row[lo] == v;
}

// One lane's share of a row step: counts a live value (≤ τ), and returns
// whether the value lies past the live prefix.
struct LiveCount {
  uint32_t tau;
  const uint32_t* q;
  int nq;
  int nx = 0;
  int kcap = 0;
  uint32_t ux = 0;

  __device__ __forceinline__ bool take(uint32_t v) {
    if (v > tau) return true;
    ++nx;
    ux = max(ux, v);
    kcap += member(q, nq, v);
    return false;
  }
};

__global__ void __launch_bounds__(kThreads) gather_score_kernel(
    const uint32_t* __restrict__ xv, const uint32_t* __restrict__ xt,
    const uint32_t* __restrict__ xb, int64_t m, int c, int w,
    const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qt,
    const uint32_t* __restrict__ qb, const int32_t* __restrict__ qs, int gq,
    int cq, const int32_t* __restrict__ cand_rec,
    const int32_t* __restrict__ cand_q, int64_t p, float* __restrict__ out) {
  const int sub = threadIdx.x & (kGroup - 1);
  const unsigned mask = kGroupMask << ((threadIdx.x & 31) & ~(kGroup - 1));
  const int64_t i =
      (int64_t)blockIdx.x * kPairsPerBlock + threadIdx.x / kGroup;
  if (i >= p) return;  // the whole group: its lanes share i
  const int64_t r = cand_rec[i];
  const int g = cand_q[i];
  if (r < 0 || r >= m || g < 0 || g >= gq) {
    if (sub == 0) out[i] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const uint32_t* xrow = xv + r * c;
  const uint32_t* qrow = qv + (int64_t)g * cq;
  const uint32_t tau = min(xt[r], qt[g]);
  int o1 = 0;
  for (int t = sub; t < w; t += kGroup) {
    o1 += __popc(xb[r * w + t] & qb[(int64_t)g * w + t]);
  }
  LiveCount live{tau, qrow, upper_bound(qrow, cq, tau)};
  if ((c % 4 == 0) && (reinterpret_cast<uintptr_t>(xv) % 16 == 0)) {
    // Steps of 16-B vectors: 2 (one sector), then kGroup a step.
    const uint4* x4 = reinterpret_cast<const uint4*>(xrow);
    const int nvec = c / 4;
    for (int base = 0, width = 2; base < nvec; base += width, width = kGroup) {
      bool over = false;
      if (sub < width && base + sub < nvec) {
        const uint4 v = x4[base + sub];
        over |= live.take(v.x);
        over |= live.take(v.y);
        over |= live.take(v.z);
        over |= live.take(v.w);
      }
      if (__ballot_sync(mask, over)) break;
    }
  } else {
    for (int base = 0; base < c; base += kGroup) {
      const bool over = base + sub < c && live.take(xrow[base + sub]);
      if (__ballot_sync(mask, over)) break;
    }
  }
  const int nx = group_sum(mask, live.nx);
  const int kcap = group_sum(mask, live.kcap);
  const uint32_t ux = group_max(mask, live.ux);
  o1 = group_sum(mask, o1);
  if (sub == 0) {
    const int nq = live.nq;
    const uint32_t uq = nq > 0 ? qrow[nq - 1] : 0u;
    out[i] = repro::gbkmv_pair_tail(nx, nq, kcap, ux > uq ? ux : uq, o1,
                                    qs[g]);
  }
}

}  // namespace

// x*: u32 values [m, c], thresholds [m], buffers [m, w]; q*: values [gq, cq],
// thresholds [gq], buffers [gq, w], sizes i32 [gq]; cand_rec, cand_q:
// i32 [p]; out: f32 [p]. Launches on `stream` of card `device` (made
// current for the call) and returns a CUDA error code; p = 0 launches
// nothing.
extern "C" int gather_score_launch(const void* xv, const void* xt,
                                   const void* xb, int64_t m, int c, int w,
                                   const void* qv, const void* qt,
                                   const void* qb, const void* qs, int gq,
                                   int cq, const void* cand_rec,
                                   const void* cand_q, int64_t p, void* out,
                                   int device, void* stream) {
  const int64_t blocks = (p + kPairsPerBlock - 1) / kPairsPerBlock;
  if (m < 0 || c < 0 || w < 0 || gq < 0 || cq < 0 || p < 0 ||
      blocks > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (p == 0) return 0;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  gather_score_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)xv, (const uint32_t*)xt, (const uint32_t*)xb, m, c, w,
      (const uint32_t*)qv, (const uint32_t*)qt, (const uint32_t*)qb,
      (const int32_t*)qs, gq, cq, (const int32_t*)cand_rec,
      (const int32_t*)cand_q, p, (float*)out);
  return (int)cudaGetLastError();
}
