// Rotation parameters (theta, cos, sin) for k Jacobi pivots in Q2.29 fixed
// point: vectoring-mode CORDIC for atan2(2 apq, app - aqq), the one-bit
// right shift theta = -angle / 2, then rotation-mode CORDIC for (cos, sin).
//
// Replaces the TPU kernel repro/kernels/cordic.py::cordic_rotation_params
// (body _cordic_kernel), whose VPU runs each shift-add stage across the
// lanes of a block.  Here one thread takes one pivot through the 60 stages
// in int32 registers.  Vectoring mode is the core solver's (cordic.cuh,
// shared with csrc/jacobi_sweep.cu; its power-of-two scale is built from
// the exponent bits, exact, where the TPU kernel spells it
// exp2(-ceil(log2(mag)))).  Rotation mode follows the TPU kernel, not the
// core: the seed is round(2^29 / K) = 326016437 and there is no fold.
//
// CUDA's >> on a signed int is arithmetic, as jnp's is; __float2int_rn
// rounds half to even, as jnp.round does; the float steps use __fmul_rn /
// __fadd_rn so nvcc contracts nothing into an FMA.  The result is bitwise
// the plain version (kernels/ref.py::cordic_rotation_params_q29).
//
// Bound: 24 bytes a pivot (three fp32 in, three out) against about 500
// integer and float operations; at k = 2^20 bytes and operations take
// microseconds either way.  At one round's k = 392 the floor is latency:
// a pivot's longest chain of dependent instructions (233 in the SASS,
// about 980 cycles, 0.49 us at 1.98 GHz; 262 and 1100 when from_fixed
// was an IEEE division and each mode spelled its stage) after the load
// of its inputs, inside a launch that alone takes about 1 us on the
// device: 0.0020 ms a call there on an H100 SXM (700 W), from 0.0021.
// Both candidates of a stage selected on the sign (a shorter chain by
// the SASS, more constant loads) ran slower.  The three outputs are the
// rows of one (3, k) buffer: the wrapper allocates once.
#include <stdint.h>

#include "common.cuh"
#include "cordic.cuh"

namespace {

constexpr int32_t kX0 = 326016437;  // round(2^29 / K)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cordic_kernel(const float* __restrict__ apq, const float* __restrict__ app,
              const float* __restrict__ aqq, float* __restrict__ out, int k) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= k) return;
  const float y = __fmul_rn(2.f, apq[j]);
  const float x = __fsub_rn(app[j], aqq[j]);
  const float theta = __fmul_rn(-0.5f, cordic_atan2(y, x));

  int32_t zr = to_fixed(theta);
  int32_t xr = kX0;
  int32_t yr = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_ITERS; ++i)
    cordic_stage(zr >= 0, i, kAtanFixed[i], xr, yr, zr);
  const size_t row = static_cast<size_t>(k);
  out[j] = theta;
  out[row + j] = from_fixed(xr);
  out[2 * row + j] = from_fixed(yr);
}

}  // namespace

// out: (3, k) fp32, rows theta, cos, sin
extern "C" int repro_cordic(const float* apq, const float* app,
                            const float* aqq, float* out, int k,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cordic_kernel<<<(k + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      apq, app, aqq, out, k);
  return repro::launch_status();
}
