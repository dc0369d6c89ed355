// One-time setup of a kernel on each device, shared by flash_fwd.cu and
// flash_bwd.cu. cudaFuncSetAttribute (the grant of more than 48 KB of
// dynamic shared memory, the carveout) acts on the current device only, so
// a grant made once per process would leave every other card without it
// and their launches refused. A PerDevice holds one result per device: the
// first launch on a device runs the grant there (the wrapper makes the
// tensors' device the current one), later launches read its result.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace per_device {

constexpr int kMaxDevices = 64;

struct PerDevice {
  std::once_flag once[kMaxDevices];
  cudaError_t err[kMaxDevices];

  // grant() on the current device, once; its result on every call.
  template <typename Grant>
  cudaError_t get(Grant grant) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once[dev], [&] { err[dev] = grant(); });
    return err[dev];
  }
};

}  // namespace per_device
