// Shared helpers for the port's kernels (plain C interface, bound with
// ctypes from repro_torch/kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace repro
