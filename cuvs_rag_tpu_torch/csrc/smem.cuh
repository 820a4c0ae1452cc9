// Raising a kernel's dynamic shared-memory limit before a launch, from any
// number of host threads. Included by every source whose kernels take more
// than the default 48 KB (ring.cuh brings it to flat_topk.cu and
// ivf_scan.cu). Everything has internal linkage: each .cu file compiles its
// own copy.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int MAX_DEVICES = 64;

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// `allowed` is the launch site's own table for this kernel instance, by
// device: the largest size set so far (each instance has one launch site).
// cudaFuncAttributeMaxDynamicSharedMemorySize is per kernel and shared by
// every thread of the process, so two threads that launch one kernel with
// different sizes must never lower it under each other: the attribute is
// only ever raised, under a lock, and a size is recorded only after its set
// succeeded. A size already allowed costs one atomic read and no lock.
template <typename Kernel>
cudaError_t allow_smem(int (&allowed)[MAX_DEVICES], Kernel kernel, int bytes) {
  static std::mutex lock;  // one per kernel signature: sets are rare
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= __atomic_load_n(&allowed[dev], __ATOMIC_ACQUIRE))
    return cudaSuccess;
  std::lock_guard<std::mutex> guard(lock);
  if (bytes <= __atomic_load_n(&allowed[dev], __ATOMIC_ACQUIRE))
    return cudaSuccess;  // another thread raised it meanwhile
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) __atomic_store_n(&allowed[dev], bytes, __ATOMIC_RELEASE);
  return e;
}

}  // namespace
