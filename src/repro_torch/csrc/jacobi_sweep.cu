// One Jacobi pivot round over a batch: (C, V) (B, n, n) fp32 -> (C'', V'').
//
// Replaces the TPU kernel repro/kernels/fused.py::jacobi_sweep_step (body
// _sweep_kernel): gather apq/app/aqq for k disjoint (p, q) pairs -> angle
// (rutishauser | atan2 | Q2.29 CORDIC) -> null-pivot guard -> rotate the
// rows, then the columns of C, and the columns of V.  On the TPU the whole
// (n, n) C and V sit in VMEM for one grid step; on Hopper a 784 x 784 pair
// does not fit one block's shared memory, so the round is two launches:
//
//   1. angles_kernel: one thread per (b, pair) computes (c, s) once into a
//      (B, k, 2) scratch, with the arithmetic of repro_torch/core/cordic.py
//      operation for operation (IEEE sqrt and division: never build with
//      fast math);
//   2. rotate_kernel: out of place, one thread per output element.  Each
//      C''[r, c] depends only on the 2 x 2 block of the old C at
//      (pair(r), pair(c)): first the row combine, in the reference's order,
//      then the column combine; rows and columns in no pair pass through
//      (the "cyclic" single-pair case).  V'' needs the column combine only.
//      Each block builds the coordinate -> pair table in shared memory.
//
// Products and sums use __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot
// contract c*x - s*y into an FMA: the rotation is then the same float
// arithmetic as the plain PyTorch version, and a null pivot (c = 1, s = 0)
// leaves padded coordinates exactly zero.
//
// Bound: C and V read once and written once per round, 4 * 4 * n^2 bytes
// (9.8 MB at n = 784, ~3 us at 3.35 TB/s).  Both fit in the 50 MB L2.  At
// that size the two launches and the host loop over rounds dominate; one
// launch per sweep with C and V on chip is later work.
#include <stdint.h>

#include "common.cuh"
#include "cordic.cuh"

namespace {

constexpr int MODE_RUTISHAUSER = 0;
constexpr int MODE_ATAN2 = 1;
constexpr int MODE_CORDIC = 2;

// rotation seed round(f32(1/K) * 2^29), as repro_torch/core/cordic.py
constexpr int32_t kX0Fixed = 326016448;
constexpr float kHalfPi = 1.57079637050628662f;    // float32(pi / 2)

__device__ void cordic_sincos(float theta, float* sin_out, float* cos_out) {
  const bool fold_hi = theta > kHalfPi;
  const bool fold_lo = theta < -kHalfPi;
  const float th = fold_hi ? __fsub_rn(theta, kPi)
                           : (fold_lo ? __fadd_rn(theta, kPi) : theta);
  int32_t zi = to_fixed(th);
  int32_t xi = kX0Fixed;
  int32_t yi = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_ITERS; ++i) {
    const int32_t d = zi >= 0 ? 1 : -1;
    const int32_t xs = xi >> i;
    const int32_t ys = yi >> i;
    xi = xi - d * ys;
    yi = yi + d * xs;
    zi = zi - d * kAtanFixed[i];
  }
  const float sign = (fold_hi || fold_lo) ? -1.f : 1.f;
  *sin_out = __fmul_rn(from_fixed(yi), sign);
  *cos_out = __fmul_rn(from_fixed(xi), sign);
}

__device__ void rotation(float apq, float app, float aqq, int mode, float* c,
                         float* s) {
  if (mode == MODE_RUTISHAUSER) {
    const bool safe = fabsf(apq) > 0.f;
    const float den = safe ? __fmul_rn(2.f, apq) : 1.f;
    const float tau = __fdiv_rn(__fsub_rn(app, aqq), den);
    const float sgn = tau >= 0.f ? 1.f : -1.f;
    float t = __fdiv_rn(
        sgn, __fadd_rn(fabsf(tau),
                       __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)))));
    t = safe ? -t : 0.f;
    // c rounded once from double, as core/cordic.py does (two float
    // roundings bias c^2 + s^2 above 1 and the eigenvalues drift)
    const double u = static_cast<double>(__fadd_rn(1.f, __fmul_rn(t, t)));
    *c = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn(u)));
    *s = __fmul_rn(t, *c);
  } else if (mode == MODE_ATAN2) {
    const float theta =
        __fmul_rn(-0.5f, atan2f(__fmul_rn(2.f, apq), __fsub_rn(app, aqq)));
    *c = cosf(theta);
    *s = sinf(theta);
  } else {
    const float full = cordic_atan2(__fmul_rn(2.f, apq), __fsub_rn(app, aqq));
    cordic_sincos(__fmul_rn(-0.5f, full), s, c);
  }
}

// The pairs come from the host's pivot schedule; one out of [0, n) would
// read and write outside C, so it is no rotation at all.
__device__ __forceinline__ bool in_range(int p, int q, int n) {
  return p >= 0 && p < n && q >= 0 && q < n;
}

__global__ void angles_kernel(const float* __restrict__ C,
                              const int32_t* __restrict__ pairs,
                              float* __restrict__ cs, int n, int k,
                              int mode) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= k) return;
  const int p = pairs[2 * j];
  const int q = pairs[2 * j + 1];
  float c = 1.f, s = 0.f;
  if (in_range(p, q, n)) {  // rotate_kernel skips a pair out of range
    const float* Cb = C + static_cast<size_t>(b) * n * n;
    const float apq = Cb[static_cast<size_t>(p) * n + q];
    const float app = Cb[static_cast<size_t>(p) * n + p];
    const float aqq = Cb[static_cast<size_t>(q) * n + q];
    rotation(apq, app, aqq, mode, &c, &s);
    if (apq == 0.f || p == q) {  // null-pivot guard: the exact identity
      c = 1.f;
      s = 0.f;
    }
  }
  float* o = cs + (static_cast<size_t>(b) * k + j) * 2;
  o[0] = c;
  o[1] = s;
}

// role 0: the p side, c*x_p - s*x_q; role 1: the q side, s*x_p + c*x_q
__device__ __forceinline__ float combine(int role, float c, float s, float xp,
                                         float xq) {
  return role == 0 ? __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq))
                   : __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
}

constexpr int RT = 32;  // output tile edge
constexpr int RY = 8;   // block is RT x RY threads, RT / RY rows each

__global__ void __launch_bounds__(RT* RY)
rotate_kernel(const float* __restrict__ C, const float* __restrict__ V,
              const int32_t* __restrict__ pairs, const float* __restrict__ cs,
              float* __restrict__ Co, float* __restrict__ Vo, int n, int k) {
  extern __shared__ int slot[];  // coordinate -> 2 * pair + role, or -1
  const int tid = threadIdx.y * RT + threadIdx.x;
  for (int i = tid; i < n; i += RT * RY) slot[i] = -1;
  __syncthreads();
  for (int j = tid; j < k; j += RT * RY) {
    const int p = pairs[2 * j];
    const int q = pairs[2 * j + 1];
    if (in_range(p, q, n)) {
      slot[p] = 2 * j;
      slot[q] = 2 * j + 1;
    }
  }
  __syncthreads();

  const int b = blockIdx.z;
  const size_t off = static_cast<size_t>(b) * n * n;
  const float* Cb = C + off;
  const float* Vb = V + off;
  const float* csb = cs + static_cast<size_t>(b) * k * 2;

  // C'(r, c) after the row combine
  auto row_rotated = [&](int r, int col) -> float {
    const int sr = slot[r];
    if (sr < 0) return Cb[static_cast<size_t>(r) * n + col];
    const int j = sr >> 1;
    const int p = pairs[2 * j];
    const int q = pairs[2 * j + 1];
    return combine(sr & 1, csb[2 * j], csb[2 * j + 1],
                   Cb[static_cast<size_t>(p) * n + col],
                   Cb[static_cast<size_t>(q) * n + col]);
  };

  const int col = blockIdx.x * RT + threadIdx.x;
  if (col >= n) return;
  const int sc = slot[col];
  int cp = col, cq = col, role = 0;
  float cc = 1.f, ss = 0.f;
  if (sc >= 0) {
    const int j = sc >> 1;
    cp = pairs[2 * j];
    cq = pairs[2 * j + 1];
    role = sc & 1;
    cc = csb[2 * j];
    ss = csb[2 * j + 1];
  }
  for (int rr = threadIdx.y; rr < RT; rr += RY) {
    const int r = blockIdx.y * RT + rr;
    if (r >= n) break;
    const size_t idx = static_cast<size_t>(r) * n + col;
    if (sc < 0) {
      Co[off + idx] = row_rotated(r, col);
      Vo[off + idx] = Vb[idx];
    } else {
      Co[off + idx] = combine(role, cc, ss, row_rotated(r, cp),
                              row_rotated(r, cq));
      Vo[off + idx] = combine(role, cc, ss, Vb[static_cast<size_t>(r) * n + cp],
                              Vb[static_cast<size_t>(r) * n + cq]);
    }
  }
}

}  // namespace

// mode: 0 rutishauser, 1 atan2, 2 cordic.  cs is a (batch, k, 2) float
// scratch; Co/Vo must not alias C/V.
extern "C" int repro_jacobi_sweep(const float* C, const float* V,
                                  const int32_t* pairs, float* cs, float* Co,
                                  float* Vo, int batch, int n, int k,
                                  int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  angles_kernel<<<dim3((k + threads - 1) / threads, batch), threads, 0, s>>>(
      C, pairs, cs, n, k, mode);
  int status = repro::launch_status();
  if (status) return status;
  const int tiles = (n + RT - 1) / RT;
  rotate_kernel<<<dim3(tiles, tiles, batch), dim3(RT, RY),
                  static_cast<size_t>(n) * sizeof(int), s>>>(C, V, pairs, cs,
                                                             Co, Vo, n, k);
  return repro::launch_status();
}
