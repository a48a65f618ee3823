// Q2.29 CORDIC shared by csrc/jacobi_sweep.cu (the core solver's CORDIC
// angle mode) and csrc/cordic.cu (the standalone CORDIC unit): the atan
// table, the fixed-point conversions, the exact power-of-two scale and
// vectoring mode.  The two differ only in rotation mode (seed and fold),
// which each file keeps.  Products and sums use __fmul_rn / __fadd_rn so
// nvcc contracts nothing into an FMA: the results are bitwise the plain
// PyTorch versions.  Included at file scope; the anonymous namespace gives
// each translation unit its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Q2.29 constants: round(atan(2^-i) * 2^29); repro_torch/core/cordic.py
// computes the same numbers (a test holds this table against it).
constexpr int CORDIC_ITERS = 30;
__constant__ int32_t kAtanFixed[CORDIC_ITERS] = {
    421657428, 248918915, 131521918, 66762579, 33510843, 16771758,
    8387925,   4194219,   2097141,   1048575,  524288,   262144,
    131072,    65536,     32768,     16384,    8192,     4096,
    2048,      1024,      512,       256,      128,      64,
    32,        16,        8,         4,        2,        1};
constexpr float kOne = 536870912.0f;  // 2^29
constexpr float kPi = 3.14159274101257324f;        // float32(pi)

__device__ __forceinline__ int32_t to_fixed(float x) {
  return __float2int_rn(__fmul_rn(x, kOne));  // round half to even
}

__device__ __forceinline__ float from_fixed(int32_t x) {
  return __fdiv_rn(__int2float_rn(x), kOne);
}

// 2^-ceil(log2(mag)) from the exponent bits of a positive normal float:
// exact, where log2f/exp2f could round across an integer
__device__ __forceinline__ float pow2_scale(float mag) {
  const int bits = __float_as_int(mag);
  int ceil_log2 = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0 ? 1 : 0);
  ceil_log2 = min(max(ceil_log2, -126), 126);
  return __int_as_float((127 - ceil_log2) << 23);
}

__device__ float cordic_atan2(float y, float x) {
  const float mag = fmaxf(fmaxf(fabsf(y), fabsf(x)), 1e-30f);
  const float scale = pow2_scale(mag);
  const float yn = __fmul_rn(y, scale);
  const float xn = __fmul_rn(x, scale);
  const bool neg_x = xn < 0.f;
  int32_t xi = to_fixed(neg_x ? -xn : xn);
  int32_t yi = to_fixed(neg_x ? -yn : yn);
  int32_t zi = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_ITERS; ++i) {
    const int32_t d = yi >= 0 ? 1 : -1;
    const int32_t xs = xi >> i;  // arithmetic shift on int32
    const int32_t ys = yi >> i;
    xi = xi + d * ys;
    yi = yi - d * xs;
    zi = zi + d * kAtanFixed[i];
  }
  const float ang = from_fixed(zi);
  if (!neg_x) return ang;
  return y >= 0.f ? __fadd_rn(ang, kPi) : __fsub_rn(ang, kPi);
}

}  // namespace
