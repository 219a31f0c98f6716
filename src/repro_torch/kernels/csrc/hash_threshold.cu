// Fingerprint hash + global-τ filter over a flat element-id stream.
//
// Replaces the Pallas kernel `_hash_kernel` of
// src/repro/kernels/hash_threshold.py (B2), which mixes [R, 128] lane tiles.
//
// Bound on the H100: memory. Each id costs 4 bytes read and 4 written (the
// hash; 8 when the caller also asks for the keep flag) against about ten
// integer operations, so the pass runs at the card's memory rate
// (3.35 TB/s), far below its ALU rate. The device build asks for hashes
// only: its τ is chosen from them, so no keep flag could be known yet.
//
// Design: one thread per id over the flat stream, grid-stride, with the
// ragged tail masked by the loop bound — no tile padding, so no byte is
// moved that the caller did not ask for. Neighbouring threads touch
// neighbouring words, so every load and store is coalesced. u32 arithmetic
// wraps natively, which is the reference's semantics bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void hash_threshold_kernel(const uint32_t* __restrict__ ids,
                                      uint32_t* __restrict__ h_out,
                                      int32_t* __restrict__ keep_out,
                                      int64_t n, uint32_t offset,
                                      uint32_t tau) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = ids[i] + offset;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    h_out[i] = h;
    if (keep_out != nullptr) keep_out[i] = h <= tau ? 1 : 0;
  }
}

}  // namespace

// ids, h_out: u32[n]; keep_out: i32[n], or null to write no flags. `offset` is 0x9E3779B9·(seed+1)
// mod 2^32. Launches on `stream` and returns cudaGetLastError().
extern "C" int hash_threshold_launch(const void* ids, void* h_out,
                                     void* keep_out, int64_t n,
                                     uint32_t offset, uint32_t tau,
                                     void* stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  hash_threshold_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)ids, (uint32_t*)h_out, (int32_t*)keep_out, n, offset,
      tau);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
