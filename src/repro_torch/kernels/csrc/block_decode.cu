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
// Bound on the H100: the counts' zeroing, then latency. The function
// writes the [m, gq] counts once (30.7 MB at NETFLIX) and needs only the
// touched blocks' bodies and headers besides (a NETFLIX batch of 16
// queries touches 572 blocks). So the decode's own time is a chain of
// dependent loads (the task's lane, its row, the block's header, its
// body) and then the atomics; the design keeps that chain short and runs
// it while the counts are zeroed:
//
//   - The zeroing is a kernel of this file, and the decode is launched
//     after it with programmatic dependent launch: the decode finds its
//     blocks and unpacks their ids while the counts are zeroed, and waits
//     for the zeroing (griddepcontrol.wait) only before its first atomic.
//   - A warp a task, a fixed grid striding over the tasks up to their
//     total, read from device memory. The task's lane is found by a 32-ary
//     search of `cum` with warp ballots: the first level (the ends of 32
//     spans, the last of which is the total) is loaded once per warp, each
//     further level is one coalesced load of 32 entries, and the last one
//     fetches `pos` beside `cum`; the lane that owns the task then loads
//     its row's first block. 32-bit indices throughout (the entry refuses
//     shapes that need more).
//   - sparse block  lane l unpacks deltas 4l .. 4l + 3 (bw bits at bit
//                   (i−1)·bw, two straddled words joined by 32-bit
//                   shift-or, as the reference), a warp scan of the lanes'
//                   sums adds `first`;
//     dense block   lane l takes body words l, l + 32, l + 64, l + 96 (at
//                   most 124), a warp scan of each round's popcounts gives
//                   the rank of its first set bit, and each set bit of
//                   rank < 128 is one id.
//
// Counts are integers, so the order of the atomics cannot change them.
// Hazards kept from the reference: a shift by 32 is never taken (sh > 0
// guard), bw = 0 gives no delta, a word past the payload reads as 0, and
// an id outside [0, m) is never written.

#include <cstdint>
#include <cuda_runtime.h>

#include "cta_scan.cuh"
#include "launch_util.cuh"

namespace {

constexpr int kBlock = 128;          // entries per block
constexpr int kDenseMaxWords = 124;  // largest dense body
constexpr int kThreads = 128;        // a CTA: four warps, a task each
constexpr int kWarps = kThreads / 32;
constexpr unsigned kDecodeBlocks = 132 * 4;
constexpr unsigned kZeroBlocks = 132 * 2;
constexpr int kZeroThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void count_id(uint32_t id, uint32_t m, uint32_t gq,
                                         uint32_t g, int32_t* kcount) {
  if (id < m) atomicAdd(kcount + (id * gq + g), 1);
}

// Waits until the zeroing kernel launched before this one has finished
// and its stores are visible; returns at once when this launch does not
// depend on one.
__device__ __forceinline__ void wait_for_zeroed_counts() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) block_decode_kernel(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ cum, int n,
    int top, const int32_t* __restrict__ row_blocks,
    const int32_t* __restrict__ first, const uint32_t* __restrict__ meta,
    const int32_t* __restrict__ off, uint32_t nb,
    const uint32_t* __restrict__ payload, uint32_t p_words, uint32_t gq,
    uint32_t cq, uint32_t m, int32_t* __restrict__ kcount) {
  const int lane = threadIdx.x & 31;
  // Level one of the search, the same for every task: lane j holds cum at
  // the end of the j-th span of `top` lanes (lane 31's is the total), and
  // with top = 1 that lane's pos too.
  const int i_top = (int)min((int64_t)(lane + 1) * top, (int64_t)n) - 1;
  const int c_top = __ldg(cum + i_top);
  const int p_top = top == 1 ? __ldg(pos + i_top) : 0;
  const int total = __shfl_sync(kFull, c_top, 31);
  const int stride = gridDim.x * kWarps;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < total;
       t += stride) {
    // The lane owning task t is the first whose cum exceeds t. Each level
    // narrows [lo, lo + 32 · span) to one of its 32 sub-spans; `before` is
    // cum at the lane before lo (0 at lo = 0), and lane j's c is cum at
    // the end of sub-span j (clipped to the last lane).
    int c = c_top, p = p_top, lo = 0, before = 0;
    for (int span = top; span > 1;) {
      const int k = __ffs(__ballot_sync(kFull, c > t)) - 1;
      const int left = __shfl_sync(kFull, c, (k + 31) & 31);
      if (k > 0) before = left;
      lo += k * span;
      span >>= 5;
      // lo + 32 · span ≤ lo + top < 2n: unsigned holds it.
      const uint32_t i = min((uint32_t)lo - 1u + (uint32_t)(lane + 1) * span,
                             (uint32_t)n - 1u);
      c = __ldg(cum + i);
      if (span == 1) p = __ldg(pos + i);
    }
    // Lane j now holds lane lo + j's cum and pos: the owner is the one
    // lane whose cum passes t while its predecessor's does not, and it
    // loads its row's first block at once.
    const int up = __shfl_up_sync(kFull, c, 1);
    const int prev = lane == 0 ? before : up;
    const bool own = c > t && prev <= t;
    uint32_t b = 0;
    if (own) b = (uint32_t)__ldg(row_blocks + p) + (uint32_t)(t - prev);
    const int k = __ffs(__ballot_sync(kFull, own)) - 1;
    b = __shfl_sync(kFull, b, k);
    if (b >= nb) continue;  // uniform over the warp
    const uint32_t g = (uint32_t)(lo + k) / cq;
    const uint32_t mt = __ldg(meta + b);
    const uint32_t bfirst = (uint32_t)__ldg(first + b);
    const uint32_t o = (uint32_t)__ldg(off + b);
    if (((mt >> 13) & 1u) == 0u) {
      const int cnt = (int)(mt & 0x7Fu) + 1;
      const uint32_t bw = (mt >> 8) & 0x1Fu;
      uint32_t run[4];
      uint32_t acc = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 4 * lane + q;
        uint32_t delta = 0;
        if (e >= 1 && e < cnt && bw > 0) {
          const uint32_t bitpos = (uint32_t)(e - 1) * bw;
          const uint32_t w = o + (bitpos >> 5);
          const uint32_t sh = bitpos & 31u;
          const uint32_t w0 = w < p_words ? __ldg(payload + w) : 0u;
          const uint32_t w1 =
              (sh > 0 && w + 1 < p_words) ? __ldg(payload + w + 1) : 0u;
          const uint32_t hi_bits = sh > 0 ? (w1 << (32u - sh)) : 0u;
          delta = ((w0 >> sh) | hi_bits) & ((1u << bw) - 1u);
        }
        acc += delta;
        run[q] = acc;
      }
      const uint32_t excl = warp_inclusive_scan(acc) - acc;
      wait_for_zeroed_counts();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * lane + q < cnt) {
          count_id(bfirst + excl + run[q], m, gq, g, kcount);
        }
      }
    } else {
      const int nw = max(0, min(__ldg(off + b + 1) - (int)o, kDenseMaxWords));
      uint32_t word[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t j = (uint32_t)(lane + 32 * q);
        word[q] = (j < (uint32_t)nw && o + j < p_words) ? __ldg(payload + o + j)
                                                        : 0u;
      }
      wait_for_zeroed_counts();
      uint32_t rank0 = 0;  // set bits in the rounds before this one
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (32 * q >= nw || rank0 >= (uint32_t)kBlock) break;  // uniform
        uint32_t w = word[q];
        const uint32_t pc = (uint32_t)__popc(w);
        const uint32_t incl = warp_inclusive_scan(pc);
        uint32_t rank = rank0 + incl - pc;
        const uint32_t base = bfirst + (uint32_t)(lane + 32 * q) * 32u;
        while (w != 0u && rank < (uint32_t)kBlock) {
          count_id(base + (uint32_t)(__ffs(w) - 1), m, gq, g, kcount);
          w &= w - 1u;
          ++rank;
        }
        rank0 += __shfl_sync(kFull, incl, 31);
      }
    }
  }
}

// Zeroes `cells` counts, after letting the kernel launched next on the
// stream start (it waits for this grid before its first atomic). The
// counts are 4-byte aligned; the words before the first 16-byte boundary
// and after the last are zeroed one by one, the rest in 16-byte stores.
__global__ void __launch_bounds__(kZeroThreads) zero_counts_kernel(
    int32_t* __restrict__ p, uint32_t cells) {
  asm volatile("griddepcontrol.launch_dependents;");
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t head =
      min((uint32_t)((16u - ((uintptr_t)p & 15u)) & 15u) / 4u, cells);
  const uint32_t quads = (cells - head) / 4u;
  const uint32_t tail = head + 4u * quads;
  if (tid < head) p[tid] = 0;
  if (tid < cells - tail) p[tail + tid] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (uint32_t i = tid; i < quads; i += gridDim.x * blockDim.x) {
    q[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The span of the search's first level: the least power of 32 whose 32
// spans cover n lanes.
int top_span(int n) {
  int s = 1;
  while ((int64_t)s * 32 < n) s *= 32;
  return s;
}

}  // namespace

// pos, cum: i32 [n] (cum inclusive, hit-masked block counts); row_blocks
// i32 [U+1]; first i32 [nb]; meta u32 [nb]; off i32 [nb+1]; payload u32
// [p_words]; kcount i32 [m · gq], 4-byte aligned. n ≤ gq · cq, and n, nb,
// p_words and m · gq below 2^31 (the kernel's indices are 32-bit): other
// shapes are refused with cudaErrorInvalidValue. When `zero_counts` is
// set (the wrapper always sets it) the counts are zeroed first, by a
// kernel the decode is launched against with programmatic dependent
// launch; 0 adds onto the counts as they are, which times the decode
// alone. Both go on `stream` of card `device` (made current for the
// call); returns the first launch error. n, nb and m are positive (the
// caller skips the call otherwise).
extern "C" int block_decode_launch(const void* pos, const void* cum,
                                   int64_t n, const void* row_blocks,
                                   const void* first, const void* meta,
                                   const void* off, int64_t nb,
                                   const void* payload, int64_t p_words,
                                   int gq, int cq, int64_t m, void* kcount,
                                   int zero_counts, int device, void* stream) {
  if (n <= 0 || n > INT32_MAX || nb <= 0 || nb > INT32_MAX || p_words < 0 ||
      p_words > INT32_MAX || gq <= 0 || cq <= 0 || n > (int64_t)gq * cq ||
      m <= 0 || m > INT32_MAX || m * gq > INT32_MAX ||
      (uintptr_t)kcount % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const cudaStream_t st = (cudaStream_t)stream;
  if (zero_counts) {
    zero_counts_kernel<<<kZeroBlocks, kZeroThreads, 0, st>>>(
        (int32_t*)kcount, (uint32_t)(m * gq));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kDecodeBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = zero_counts ? 1 : 0;
  // The task count stays on the device; the grid is fixed and strides.
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, block_decode_kernel, (const int32_t*)pos, (const int32_t*)cum,
      (int)n, top_span((int)n), (const int32_t*)row_blocks,
      (const int32_t*)first, (const uint32_t*)meta, (const int32_t*)off,
      (uint32_t)nb, (const uint32_t*)payload, (uint32_t)p_words,
      (uint32_t)gq, (uint32_t)cq, (uint32_t)m, (int32_t*)kcount);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
