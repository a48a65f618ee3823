// Selective scan (Mamba-1 SSM), forward:
//
//   x_t = exp(dt_t A) x_{t-1} + (dt_t u_t) B_t,   y_t = x_t . C_t + D u_t
//
// for u, dt (batch, L, D), A (D, N) fp32, B, C (batch, L, N), D_skip (D,)
// fp32; u, dt, B and C share one dtype (fp32 or bf16), y takes it; the
// state is fp32; N <= 16.
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan (body
// _scan_kernel): a (batch, chunk) grid whose chunk dimension runs in order
// with the (D, N) state stationary in VMEM.  Here one thread owns one
// (b, d) channel: its N state values and its row of A sit in registers and
// it runs the recurrence over all L steps itself.  Consecutive threads take
// consecutive d, so each step's loads of u and dt and store of y coalesce.
// A block of 64 channels stages a chunk of 32 steps of u and dt (each
// thread starts its 64 loads before the chunk's compute) and of B_t and
// C_t (shared by the block) in shared memory.  State values past N are
// zero with zero B and C, so they stay zero and add nothing.  expf, not
// __expf: the 1e-4 contract of the reference holds over thousands of steps.
//
// Bound: u and dt read and y written once, 12 bytes a (b, t, d) -- 403 MB
// at falcon-mamba-7b's d_inner 8192 and L 4096, 0.12 ms at 3.35 TB/s -- and
// N exponentials a (b, t, d), 5.4e8 there.  The time loop is sequential,
// so 8192 channels give the card only 128 blocks of two warps each: the
// scan is latency-bound; a chunked parallel scan is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int TCH = 32;      // steps staged per chunk
constexpr int NMAX = 16;     // state size limit

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ Dskip,
            T* __restrict__ y, int L, int D, int N) {
  __shared__ float us[TCH][THREADS];
  __shared__ float dts[TCH][THREADS];
  __shared__ float bs[TCH][NMAX];
  __shared__ float cs[TCH][NMAX];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < D;

  float a[NMAX], x[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a[n] = live && n < N ? A[static_cast<size_t>(d) * N + n] : 0.f;
    x[n] = 0.f;
  }
  const float dskip = live ? Dskip[d] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * L;

  for (int t0 = 0; t0 < L; t0 += TCH) {
    const int steps = min(TCH, L - t0);
    __syncthreads();  // the last chunk is no longer read
#pragma unroll 8
    for (int tt = 0; tt < TCH; ++tt) {
      const size_t g = (row0 + t0 + tt) * D + d;
      const bool in = live && tt < steps;
      us[tt][threadIdx.x] = in ? repro::to_float(u[g]) : 0.f;
      dts[tt][threadIdx.x] = in ? repro::to_float(dt[g]) : 0.f;
    }
    for (int e = threadIdx.x; e < TCH * NMAX; e += THREADS) {
      const int tt = e / NMAX;
      const int n = e % NMAX;
      const bool in = tt < steps && n < N;
      const size_t g = (row0 + t0 + tt) * N + n;
      bs[tt][n] = in ? repro::to_float(Bm[g]) : 0.f;
      cs[tt][n] = in ? repro::to_float(Cm[g]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < steps; ++tt) {
      const float uu = us[tt][threadIdx.x];
      const float dd = dts[tt][threadIdx.x];
      const float du = dd * uu;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        x[n] = expf(dd * a[n]) * x[n] + du * bs[tt][n];
        acc += x[n] * cs[tt][n];
      }
      y[(row0 + t0 + tt) * D + d] = repro::from_float<T>(acc + dskip * uu);
    }
  }
}

}  // namespace

extern "C" int repro_mamba_scan(const void* u, const void* dt, const float* A,
                                const void* B, const void* C,
                                const float* Dskip, void* y, int is_bf16,
                                int batch, int L, int D, int N,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + THREADS - 1) / THREADS, batch);
  if (is_bf16) {
    using T = __nv_bfloat16;
    scan_kernel<T><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(u), static_cast<const T*>(dt), A,
        static_cast<const T*>(B), static_cast<const T*>(C), Dskip,
        static_cast<T*>(y), L, D, N);
  } else {
    scan_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(dt), A,
        static_cast<const float*>(B), static_cast<const float*>(C), Dskip,
        static_cast<float*>(y), L, D, N);
  }
  return repro::launch_status();
}
