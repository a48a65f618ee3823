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
constexpr float kInvOne = 1.0f / 536870912.0f;  // 2^-29, exact
constexpr float kPi = 3.14159274101257324f;        // float32(pi)

__device__ __forceinline__ int32_t to_fixed(float x) {
  return __float2int_rn(__fmul_rn(x, kOne));  // round half to even
}

// x / 2^29 as a product: 2^-29 is a power of two, so the product has the
// IEEE division's bits for every int32 (the quotient is 0 or at least
// 2^-29, normal), without the division's iterations and slow-path branch
__device__ __forceinline__ float from_fixed(int32_t x) {
  return __fmul_rn(__int2float_rn(x), kInvOne);
}

// One CORDIC stage in direction d (+1 if `up`, else -1):
// (x, y, z) -> (x - d (y >> i), y + d (x >> i), z - d t), the shift
// arithmetic on int32.  Vectoring mode is the stage in direction
// -sign(y), rotation mode the one in direction sign(z) (sign(0) = +1).
__device__ __forceinline__ void cordic_stage(bool up, int i, int32_t t,
                                             int32_t& x, int32_t& y,
                                             int32_t& z) {
  const int32_t xs = x >> i;
  const int32_t ys = y >> i;
  const int32_t d = up ? 1 : -1;
  x = x - d * ys;
  y = y + d * xs;
  z = z - d * t;
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
  for (int i = 0; i < CORDIC_ITERS; ++i)
    cordic_stage(yi < 0, i, kAtanFixed[i], xi, yi, zi);
  const float ang = from_fixed(zi);
  if (!neg_x) return ang;
  return y >= 0.f ? __fadd_rn(ang, kPi) : __fsub_rn(ang, kPi);
}

}  // namespace
