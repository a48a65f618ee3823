// Shared helpers for the port's kernels (plain C interface, bound with
// ctypes from repro_torch/kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace repro {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Every C entry point returns this: a refused launch never runs, and a
// later synchronize would not report it.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Above 48 KiB a kernel's dynamic shared memory must be asked for, or its
// launch is refused.  Asked once per kernel and device for the largest size
// launched so far, not before every launch.
inline int allow_smem(const void* kernel, size_t bytes) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const std::lock_guard<std::mutex> hold(lock);
  size_t& have = allowed[{kernel, dev}];
  if (bytes <= have) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return static_cast<int>(err);
}

template <typename Kernel>
int allow_smem(Kernel* kernel, size_t bytes) {
  return allow_smem(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace repro
