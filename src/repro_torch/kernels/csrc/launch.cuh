// The host side shared by every C entry of the kernel library.
//
// A launch from Python costs host time on every call, and at a decode
// step's shapes that time is most of the call: the device work of an
// rmsnorm over (8, 1,024) is ~2.5 us. So the entries do no per-call work
// that a process needs only once:
//  * rt_use_device makes the caller's device current only when it is not
//    already (cudaGetDevice reads a thread-local; cudaSetDevice on every
//    call did more).
//  * rt_sm_count reads the SM count once per device and keeps it.
//  * rt_once_per_device runs a setup step (a kernel's shared-memory
//    attribute) once per device and keeps its result; rt_allow_smem is
//    that step for a kernel's dynamic shared-memory limit.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace rt {

constexpr int kMaxDevices = 64;

// Make `device` the calling thread's current device.
inline cudaError_t use_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int cur = -1;
  const cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Streaming multiprocessors of `device` (0 when the query fails).
inline int sm_count(int device) {
  static std::atomic<int> cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  int n = cached[device].load(std::memory_order_relaxed);
  if (n > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  cached[device].store(n, std::memory_order_relaxed);
  return n;
}

// Run `setup` (returning cudaError_t) the first time a `Tag` is used on
// `device`, and return its first successful result from then on. Two
// threads racing here may both run it; setup steps are idempotent.
template <typename Tag, typename Setup>
inline cudaError_t once_per_device(int device, Setup setup) {
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = setup();
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <auto Kernel>
struct SmemAttr {};

// Raise a kernel's dynamic shared-memory limit to the most it takes, once
// per device.
template <auto Kernel>
inline cudaError_t allow_smem(int device, size_t bytes) {
  return once_per_device<SmemAttr<Kernel>>(device, [bytes] {
    return cudaFuncSetAttribute(Kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  });
}

}  // namespace rt
