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
// Design (measured first, `tools/score_variants.py --kernel hash_threshold`):
// the stream moves in 16-B vectors, four ids a lane and two vectors in
// flight a thread, on a persistent grid: as many blocks as the card holds
// at once (its SMs times the blocks an SM holds, asked once per card),
// each striding over the stream, or fewer where the stream is short. The
// ids before the first 16-B boundary and after the last whole vector go
// one a thread, taken by the grid's first threads. That needs the outputs
// to sit at the same offset from a 16-B boundary as the ids: where they do
// not (a slice of a stream, say), the launch takes the scalar body, one id
// a thread on the same kind of grid, and no pointer is ever read or
// written as a vector. Indices are 32-bit within a launch; the C entry
// cuts a longer stream into chunks of 2^30 ids (a multiple of four, so
// each chunk keeps the stream's alignment). u32 arithmetic wraps natively,
// which is the reference's semantics bit for bit.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // 16-B vectors in flight a thread
constexpr int64_t kChunk = int64_t{1} << 30;

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t offset) {
  uint32_t h = x + offset;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ void hash_one(const uint32_t* ids,
                                         uint32_t* h_out, int32_t* keep_out,
                                         uint32_t i, uint32_t offset,
                                         uint32_t tau) {
  const uint32_t h = mix(ids[i], offset);
  h_out[i] = h;
  if (keep_out != nullptr) keep_out[i] = h <= tau ? 1 : 0;
}

// One id a thread: streams whose outputs are not aligned with the ids.
__global__ void hash_threshold_scalar(const uint32_t* __restrict__ ids,
                                      uint32_t* __restrict__ h_out,
                                      int32_t* __restrict__ keep_out,
                                      uint32_t n, uint32_t offset,
                                      uint32_t tau) {
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    hash_one(ids, h_out, keep_out, i, offset, tau);
}

// kVecs 16-B vectors (four ids each) a thread and step, `nv` vectors from
// id `head` on; threads 0 .. head + tail - 1 also take the `head` ids
// before them and the `tail` ids after them, one each.
__global__ void hash_threshold_vec(const uint32_t* __restrict__ ids,
                                   uint32_t* __restrict__ h_out,
                                   int32_t* __restrict__ keep_out,
                                   uint32_t head, uint32_t nv, uint32_t tail,
                                   uint32_t offset, uint32_t tau) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  if (t < head + tail)
    hash_one(ids, h_out, keep_out, t < head ? t : head + 4 * nv + (t - head),
             offset, tau);
  const uint4* in = reinterpret_cast<const uint4*>(ids + head);
  uint4* out = reinterpret_cast<uint4*>(h_out + head);
  int4* kout = keep_out == nullptr
                   ? nullptr
                   : reinterpret_cast<int4*>(keep_out + head);
  for (uint32_t base = blockIdx.x * (kThreads * kVecs) + threadIdx.x;
       base < nv; base += gridDim.x * (kThreads * kVecs)) {
    uint4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint32_t j = base + k * kThreads;
      if (j < nv) v[k] = __ldg(in + j);
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const uint32_t j = base + k * kThreads;
      if (j < nv) {
        const uint4 h = make_uint4(mix(v[k].x, offset), mix(v[k].y, offset),
                                   mix(v[k].z, offset), mix(v[k].w, offset));
        out[j] = h;
        if (kout != nullptr)
          kout[j] = make_int4(h.x <= tau, h.y <= tau, h.z <= tau, h.w <= tau);
      }
    }
  }
}

// A kernel's blocks that each card holds at once, asked once per card:
// `ready` has one bit per card already asked.
struct Resident {
  std::atomic<uint64_t> ready{0};
  std::atomic<int> blocks[64];
};
Resident g_scalar, g_vec;

// Blocks of `kernel` (kThreads threads) that card `device` holds at once:
// its SMs times the blocks an SM holds.
cudaError_t resident_blocks(Resident& r, const void* kernel, int device,
                            uint32_t* out) {
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (r.ready.load(std::memory_order_acquire) & bit) {
    *out = (uint32_t)r.blocks[device].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (bit) {
    r.blocks[device].store(blocks, std::memory_order_relaxed);
    r.ready.fetch_or(bit, std::memory_order_release);
  }
  *out = (uint32_t)blocks;
  return cudaSuccess;
}

// One launch over n <= 2^30 ids on card `device`.
cudaError_t launch(const uint32_t* ids, uint32_t* h_out, int32_t* keep_out,
                   uint32_t n, uint32_t offset, uint32_t tau, int device,
                   cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ids);
  const bool aligned =
      ((a ^ reinterpret_cast<uintptr_t>(h_out)) & 15) == 0 &&
      (keep_out == nullptr ||
       ((a ^ reinterpret_cast<uintptr_t>(keep_out)) & 15) == 0);
  uint32_t blocks = 0;
  if (!aligned) {
    const cudaError_t err = resident_blocks(
        g_scalar, (const void*)hash_threshold_scalar, device, &blocks);
    if (err != cudaSuccess) return err;
    const uint32_t need = (n + kThreads - 1) / kThreads;
    hash_threshold_scalar<<<need < blocks ? need : blocks, kThreads, 0,
                            stream>>>(ids, h_out, keep_out, n, offset, tau);
    return cudaGetLastError();
  }
  // Ids up to the first 16-B boundary (an int32 tensor's data is 4-B
  // aligned, so a whole number of them).
  uint32_t head = (uint32_t)(((16 - (a & 15)) & 15) / 4);
  if (head > n) head = n;
  const uint32_t nv = (n - head) / 4, tail = (n - head) % 4;
  const cudaError_t err =
      resident_blocks(g_vec, (const void*)hash_threshold_vec, device, &blocks);
  if (err != cudaSuccess) return err;
  // At least one block, for the head and tail ids of a short stream.
  const uint32_t need = nv / (kThreads * kVecs) + 1;
  hash_threshold_vec<<<need < blocks ? need : blocks, kThreads, 0, stream>>>(
      ids, h_out, keep_out, head, nv, tail, offset, tau);
  return cudaGetLastError();
}

}  // namespace

// ids, h_out: u32[n]; keep_out: i32[n], or null to write no flags. `offset`
// is 0x9E3779B9·(seed+1) mod 2^32. Launches on `stream` on card `device`
// (in chunks of kChunk ids past that many) and returns the first CUDA
// error, or 0.
extern "C" int hash_threshold_launch(const void* ids, void* h_out,
                                     void* keep_out, int64_t n,
                                     uint32_t offset, uint32_t tau,
                                     int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  for (int64_t s = 0; s < n; s += kChunk) {
    const cudaError_t err = launch(
        (const uint32_t*)ids + s, (uint32_t*)h_out + s,
        keep_out == nullptr ? nullptr : (int32_t*)keep_out + s,
        (uint32_t)(n - s < kChunk ? n - s : kChunk), offset, tau, device,
        (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
