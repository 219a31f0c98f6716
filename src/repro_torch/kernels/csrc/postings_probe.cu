// Postings probe and block-task prefix: the front end of the device pruned
// pipeline. For each query hash, its row in the sorted tail-key column of
// the block postings and, for the lanes that hit, the running count of the
// posting blocks they own.
//
// Replaces the Pallas kernel `_probe_kernel` of
// src/repro/kernels/postings_merge.py (B3), which keeps the whole padded
// key column resident in VMEM and compares blocks of 256 query hashes
// against it in 512-key chunks, together with the block-task prefix that
// the reference's `_pipeline_scores` computes straight after the probe
// (`seg_nblk`, then `cum = jnp.cumsum(seg_nblk)`).
//
// Output per query hash q, lane i of n = Gq · Cq: pos = #keys < q in u32
// order (i32); hit = pos < U and keys[pos] == q and q != PAD (u8); and,
// when the caller passes row_blocks, cum[i] = nblk[0] + ... + nblk[i]
// (i32, inclusive) with nblk = hit ? row_blocks[pos+1] − row_blocks[pos]
// : 0. Keys are distinct u32 hashes in ascending order.
//
// Bound on the H100: launch latency, then bytes. The function needs the
// keys and the queries read once, row_blocks at the hit lanes, and pos,
// hit and cum written once: at NETFLIX (2,424 keys, 896 lanes) about 22
// KB, under 10 ns at 3.35 TB/s, against a few µs to launch anything. So
// the design spends one launch on the whole front end and keeps its
// dependent loads out of device memory:
//
//   - One CTA of up to 1,024 threads owns the lane prefix, which is one
//     sequence (a NETFLIX batch has 896 lanes); n beyond the CTA's width
//     goes in tiles with a running carry. It writes every output lane, so
//     the wrapper allocates with torch.empty and fills nothing. Without
//     row_blocks (pos and hit only) the tiles spread over several CTAs.
//   - The key column is staged once into dynamic shared memory with
//     coalesced 16-B loads: the card's counterpart of the TPU's resident
//     VMEM column (NETFLIX's keys are 9.7 KB). Each lane's lower-bound
//     binary search then makes its log2 U dependent loads there.
//   - A column over the shared-memory budget (kKeyBytes, 57,856 keys) is
//     staged as a fence table of every 2^s-th key, s the smallest shift
//     that fits (postings_probe_fence_shift, which the entry calls and
//     reports back): the first search levels run in shared memory, the
//     last s levels in device memory over the 2^s − 1 keys between two
//     fences.
//   - The block counts go through a CTA inclusive scan (warp shuffles plus
//     warp totals, cta_scan.cuh, shared with B4), with u32 compares in the
//     reference's unsigned order; a query equal to PAD never hits, as in
//     the reference, where PAD pads both the keys and the queries.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "cta_scan.cuh"
#include "launch_util.cuh"

namespace {

constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kMaxThreads = 1024;
// Dynamic shared memory for the keys or fences: a block's 232,448 B less
// 1 KB left to the scan's static scratch.
constexpr int kKeyBytes = 232448 - 1024;
constexpr int64_t kMaxSmemKeys = kKeyBytes / 4;
constexpr unsigned kMaxProbeBlocks = 132;

// First index in [lo, lo + len) of `a` whose value is not below x (lo +
// len when none is).
template <typename Index>
__device__ __forceinline__ Index lower_bound(const uint32_t* a, Index lo,
                                             Index len, uint32_t x) {
  while (len > 0) {
    const Index half = len >> 1;
    if (a[lo + half] < x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kMaxThreads) postings_probe_kernel(
    const uint32_t* __restrict__ keys, int64_t u, int shift,
    const uint32_t* __restrict__ q, int64_t n,
    const int32_t* __restrict__ row_blocks, int32_t* __restrict__ pos,
    uint8_t* __restrict__ hit, int32_t* __restrict__ cum) {
  extern __shared__ __align__(16) uint32_t sk[];   // keys or fences
  __shared__ uint32_t warp_tot[kMaxThreads / 32];
  __shared__ uint32_t tile_total;
  const int tid = threadIdx.x;
  const int64_t width = blockDim.x;
  const int64_t stride = (int64_t)gridDim.x * width;
  const int f = (int)((u + ((int64_t)1 << shift) - 1) >> shift);

  // This tile's query hash is loaded before the staging wait.
  int64_t i = (int64_t)blockIdx.x * width + tid;
  uint32_t x = i < n ? __ldg(q + i) : kPad;

  if (shift == 0) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
      const uint4* k4 = reinterpret_cast<const uint4*>(keys);
      uint4* s4 = reinterpret_cast<uint4*>(sk);
      for (int j = tid; j < f / 4; j += blockDim.x) s4[j] = __ldg(k4 + j);
      done = f / 4 * 4;
    }
    for (int j = done + tid; j < f; j += blockDim.x) sk[j] = __ldg(keys + j);
  } else {
    for (int j = tid; j < f; j += blockDim.x) {
      sk[j] = __ldg(keys + ((int64_t)j << shift));
    }
  }
  __syncthreads();

  uint32_t carry = 0;
  for (; i - tid < n; i += stride) {   // uniform over the CTA
    const int64_t next = i + stride;
    const uint32_t x_next = next < n ? __ldg(q + next) : kPad;
    int64_t p = lower_bound<int>(sk, 0, f, x);
    bool h;
    if (shift == 0) {
      h = p < u && sk[p] == x;
    } else {
      // p fences lie below x; the first key >= x is past fence p − 1 and
      // at or before fence p (or the end of the column).
      if (p > 0) {
        const int64_t lo = ((p - 1) << shift) + 1;
        const int64_t hi = p << shift < u ? p << shift : u;
        p = lower_bound<int64_t>(keys, lo, hi - lo, x);
      }
      h = p < u && __ldg(keys + p) == x;
    }
    h = h && x != kPad;
    if (i < n) {
      pos[i] = (int32_t)p;
      hit[i] = h ? 1 : 0;
    }
    if (cum != nullptr) {              // uniform: one CTA, every tile
      const uint32_t nblk =
          (i < n && h) ? (uint32_t)(__ldg(row_blocks + p + 1) -
                                    __ldg(row_blocks + p))
                       : 0u;
      const uint32_t v = cta_inclusive_scan(nblk, warp_tot);
      if (i < n) cum[i] = (int32_t)(carry + v);
      // Every thread read the last tile_total before this scan's first
      // barrier; the next write comes after it.
      if (tid == blockDim.x - 1) tile_total = v;
      __syncthreads();
      carry += tile_total;
    }
    x = x_next;
  }
}

std::atomic<uint64_t> g_smem_ready{0};

}  // namespace

// The fence stride s for a u-key column: the smallest shift for which
// every 2^s-th key fits in the shared-memory budget (0: the whole column).
extern "C" int postings_probe_fence_shift(int64_t u) {
  int s = 0;
  while (((u + ((int64_t)1 << s) - 1) >> s) > kMaxSmemKeys) ++s;
  return s;
}

// keys: u32 [u] ascending; q: u32 [n]; row_blocks: i32 [u+1] or null;
// pos: i32 [n]; hit: u8 [n]; cum: i32 [n], null exactly when row_blocks
// is. Every output lane is written. The entry picks the fence stride
// (postings_probe_fence_shift) and stores it in *shift_out when that is
// not null. Launches on `stream` of card `device` (made current for the
// call) and returns a CUDA error code. The caller skips the call when u or
// n is 0.
extern "C" int postings_probe_launch(const void* keys, int64_t u,
                                     const void* q, int64_t n,
                                     const void* row_blocks, void* pos,
                                     void* hit, void* cum, int32_t* shift_out,
                                     int device, void* stream) {
  if (u < 0 || n < 0 || (row_blocks == nullptr) != (cum == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = postings_probe_fence_shift(u);
  if (shift_out != nullptr) *shift_out = shift;
  if (n == 0) return 0;
  const int64_t f = (u + ((int64_t)1 << shift) - 1) >> shift;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const size_t smem = (size_t)((f + 3) / 4) * 16;   // whole 16-B words
  if (smem > 48 * 1024) {
    const cudaError_t err = raise_smem_limit(
        (const void*)postings_probe_kernel, kKeyBytes, g_smem_ready);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t width = n < kMaxThreads ? (n + 31) / 32 * 32 : kMaxThreads;
  const int64_t tiles = (n + width - 1) / width;
  const unsigned blocks =
      cum != nullptr ? 1u
                     : (unsigned)(tiles < kMaxProbeBlocks ? tiles
                                                           : kMaxProbeBlocks);
  postings_probe_kernel<<<blocks, (unsigned)width, smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)keys, u, shift, (const uint32_t*)q, n,
      (const int32_t*)row_blocks, (int32_t*)pos, (uint8_t*)hit,
      (int32_t*)cum);
  return (int)cudaGetLastError();
}
