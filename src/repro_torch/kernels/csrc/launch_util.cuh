// Host-side helpers of the C entry points, shared by the postings probe
// (B3), the block decode (B4) and flash attention (B6).
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device: `ready` holds one bit per device already set
// (the attribute never changes), so a launch does not repeat the call.
cudaError_t raise_smem_limit(const void* kernel, int bytes,
                             std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// Makes `device` the current device for the guard's scope and restores the
// caller's on exit, as `torch.cuda.device` does in Python, so that a
// launch goes to the card that owns the tensors and the stream. When that
// card is already current it costs one cudaGetDevice.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
