// Postings probe: for each query hash, its row in the sorted tail-key
// column of the block postings.
//
// Replaces the Pallas kernel `_probe_kernel` of
// src/repro/kernels/postings_merge.py (B3), which compares blocks of 256
// query hashes against the whole key column in 512-key chunks: contiguous
// loads and no data-dependent addressing, the layout a TPU wants.
//
// Output per query hash q: pos = #keys < q (i32) and hit = (q is a key and
// q != PAD) (u8). Keys are distinct u32 hashes in ascending order.
//
// Bound on the H100: memory, and latency in practice. The function needs
// each key and each query read once and pos/hit written once; a batch of
// 16 queries has under a thousand hashes against a few thousand keys, so
// the work is one short wave of threads.
//
// Design: one thread per query hash, a lower-bound binary search over the
// key column in device memory (log2 U dependent loads, which the first
// levels of all threads share through L1/L2) instead of the chunked
// compare, which would read all U keys per query. u32 compares are the
// reference's unsigned order; a query equal to PAD never hits, as in the
// reference, where PAD pads both the keys and the queries.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPad = 0xFFFFFFFFu;

__global__ void postings_probe_kernel(const uint32_t* __restrict__ keys,
                                      int64_t u,
                                      const uint32_t* __restrict__ q,
                                      int64_t n, int32_t* __restrict__ pos,
                                      uint8_t* __restrict__ hit) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t x = q[i];
    int64_t lo = 0, hi = u;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (keys[mid] < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    pos[i] = (int32_t)lo;
    hit[i] = (lo < u && keys[lo] == x && x != kPad) ? 1 : 0;
  }
}

}  // namespace

// keys: u32 [u] ascending; q: u32 [n]; pos: i32 [n]; hit: u8 [n].
// Launches on `stream` and returns cudaGetLastError(). The caller skips
// the launch when u or n is 0.
extern "C" int postings_probe_launch(const void* keys, int64_t u,
                                     const void* q, int64_t n, void* pos,
                                     void* hit, void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  postings_probe_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)keys, u, (const uint32_t*)q, n, (int32_t*)pos,
      (uint8_t*)hit);
  return (int)cudaGetLastError();
}
