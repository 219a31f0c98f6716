// Block decode and K∩ scatter of the pruned pipeline: every posting block
// of every query hash that hit a tail key is decoded to its record ids,
// and each id adds one to its (record, query) count.
//
// Replaces the Pallas kernel `_block_decode_kernel` of
// src/repro/kernels/postings_merge.py (B4), which decodes one sparse block
// per grid step (a dynamic-slice DMA of the 128-word body window, a
// one-hot word select, a prefix sum), together with what surrounds it in
// the reference's `_pipeline_scores`: the block-task expand, the
// dense-bitmap rank-select (`_decode_dense_jnp`, an XLA loop there) and
// the K∩ scatter-add. The reference sizes its loops by a task count that
// stays on the device; fusing them here keeps that count on the card too,
// with no host read in the middle of the pipeline.
//
// Inputs: per query-hash lane (n = gq · cq lanes) the probe's row `pos`
// and `cum`, the inclusive prefix sum of the lanes' block counts (0 for a
// lane that missed), both written by the probe (postings_probe.cu); the
// tail store's row_blocks, first, meta, off and payload. Output: kcount
// i32 [m · gq], which the entry zeroes on the launch's stream first.
//
// Bound on the H100: memory and latency. The function needs the payload
// words and headers of the touched blocks and one 4-byte atomic update per
// decoded entry; a NETFLIX batch of 16 queries touches about 600 blocks.
//
// Design: a fixed grid of 128-thread CTAs strides over the task stream up
// to its total, read from device memory. Per task one thread finds the
// lane by binary search over `cum`, then:
//   sparse block  thread i unpacks delta i−1 (bw bits at bit (i−1)·bw, two
//                 straddled words joined by 32-bit shift-or, as the
//                 reference), a CTA-wide inclusive scan adds `first`, and
//                 threads i < count scatter their ids;
//   dense block   thread j loads body word j (at most 124), popcounts it,
//                 an exclusive scan gives the rank of its first set bit,
//                 and each set bit of rank < 128 is one id.
// Counts are integers, so the order of the atomics cannot change them.
// Hazards kept from the reference: a shift by 32 is never taken (sh > 0
// guard), bw = 0 gives no delta, a word past the payload reads as 0, and
// an id outside [0, m) is never written.

#include <cstdint>
#include <cuda_runtime.h>

#include "cta_scan.cuh"
#include "launch_util.cuh"

namespace {

constexpr int kBlock = 128;          // entries per block = threads per CTA
constexpr int kDenseMaxWords = 124;  // largest dense body
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ void count_id(uint32_t id_bits, int64_t m, int gq,
                                         int g, int32_t* kcount) {
  const int32_t id = (int32_t)id_bits;
  if (id >= 0 && id < m) atomicAdd(&kcount[(int64_t)id * gq + g], 1);
}

__global__ void __launch_bounds__(kBlock) block_decode_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ cum,
    int64_t n, const int32_t* __restrict__ row_blocks,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ meta,
    const int32_t* __restrict__ off, int64_t nb,
    const uint32_t* __restrict__ payload, int64_t p_words, int gq, int cq,
    int64_t m, int32_t* __restrict__ kcount) {
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ int64_t s_blk;
  __shared__ int s_g;
  const int i = threadIdx.x;
  const int64_t total = cum[n - 1];
  for (int64_t t = blockIdx.x; t < total; t += gridDim.x) {
    if (i == 0) {
      // The lane owning task t: the first lane whose prefix sum exceeds t.
      int64_t lo = 0, hi = n;
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (cum[mid] <= t) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int64_t before = lo > 0 ? cum[lo - 1] : 0;
      s_blk = (int64_t)row_blocks[pos[lo]] + (t - before);
      s_g = (int)(lo / cq);
    }
    __syncthreads();
    const int64_t b = s_blk;
    const int g = s_g;
    if (b >= 0 && b < nb) {  // uniform over the CTA
      const uint32_t mt = meta[b];
      const uint32_t bfirst = (uint32_t)first[b];
      if (((mt >> 13) & 1u) == 0u) {
        const int cnt = (int)(mt & 0x7Fu) + 1;
        const uint32_t bw = (mt >> 8) & 0x1Fu;
        uint32_t delta = 0;
        if (i >= 1 && i < cnt && bw > 0) {
          const int64_t bitpos = (int64_t)(i - 1) * bw;
          const int64_t w = (int64_t)off[b] + (bitpos >> 5);
          const uint32_t sh = (uint32_t)(bitpos & 31);
          const uint32_t w0 = w < p_words ? payload[w] : 0u;
          const uint32_t w1 = (sh > 0 && w + 1 < p_words) ? payload[w + 1] : 0u;
          const uint32_t hi_bits = sh > 0 ? (w1 << (32u - sh)) : 0u;
          delta = ((w0 >> sh) | hi_bits) & ((1u << bw) - 1u);
        }
        const uint32_t s = cta_inclusive_scan(delta, warp_tot);
        if (i < cnt) count_id(bfirst + s, m, gq, g, kcount);
      } else {
        const int64_t o = off[b];
        const int64_t wcnt = (int64_t)off[b + 1] - o;
        uint32_t word = 0;
        if (i < wcnt && i < kDenseMaxWords && o + i < p_words) {
          word = payload[o + i];
        }
        const uint32_t c = (uint32_t)__popc(word);
        uint32_t rank = cta_inclusive_scan(c, warp_tot) - c;
        const uint32_t base = bfirst + (uint32_t)i * 32u;
        while (word != 0u && rank < (uint32_t)kBlock) {
          const uint32_t bit = (uint32_t)(__ffs(word) - 1);
          count_id(base + bit, m, gq, g, kcount);
          word &= word - 1u;
          ++rank;
        }
      }
    }
    __syncthreads();  // thread 0 rewrites s_blk for the next task
  }
}

}  // namespace

// pos, cum: i32 [n] (cum inclusive, hit-masked block counts); row_blocks
// i32 [U+1]; first i32 [nb]; meta u32 [nb]; off i32 [nb+1]; payload u32
// [p_words]; kcount i32 [m · gq], zeroed here by cudaMemsetAsync before the
// decode when `zero_counts` is set (the wrapper always sets it; 0 adds onto
// the counts as they are, which times the decode alone). Both go on
// `stream` of card `device` (made current for the call); returns the
// memset's error or cudaGetLastError(). The caller skips the call when n or
// nb is 0.
extern "C" int block_decode_launch(const void* pos, const void* cum,
                                   int64_t n, const void* row_blocks,
                                   const void* first, const void* meta,
                                   const void* off, int64_t nb,
                                   const void* payload, int64_t p_words,
                                   int gq, int cq, int64_t m, void* kcount,
                                   int zero_counts, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (zero_counts) {
    const cudaError_t err = cudaMemsetAsync(
        kcount, 0, (size_t)m * (size_t)gq * sizeof(int32_t),
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  // The task count stays on the device; the grid is fixed and strides.
  const unsigned blocks = 132 * 8;
  block_decode_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const int32_t*)cum, n,
      (const int32_t*)row_blocks, (const int32_t*)first,
      (const uint32_t*)meta, (const int32_t*)off, nb,
      (const uint32_t*)payload, p_words, gq, cq, m, (int32_t*)kcount);
  return (int)cudaGetLastError();
}
