// Batched c = a @ b with an fp32 accumulator on the CUDA cores, for
// operands of any strides; c takes a's dtype.  The MM-Engine's layout
// route (kernels/mm_engine.py::choose_kernel): an operand with unit stride
// along one of its last two dims goes to the tensor-core kernel
// (mm_engine.cu), one with neither (a strided subsample such as
// x[:, ::2]) comes here.
//
// Replaces, for those layouts, the TPU kernel
// repro/kernels/mm_engine.py::mm_engine (body _mm_kernel).  Each block owns
// one 64 x 64 output tile (4 x 4 fp32 accumulators a thread, in registers)
// and streams 16-deep panels of a and b through shared memory, one scalar
// load an element; the ragged edges are masked on load and store.
//
// a is (B, m, k) and b is (B, k, n), each given by its batch, row and
// column strides in elements (a batch stride of 0 shares the operand across
// the batch).  c is (B, m, n), contiguous.
//
// Bound: as mm_engine.cu's (the bytes of a at the projection's n = 32);
// strided scalar loads reach a fraction of the memory rate, which is the
// price of a layout no 16-byte copy can read.
#include "common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
          int m, int n, int k, long long sa, long long ars, long long acs,
          long long sb, long long brs, long long bcs) {
  const int bz = blockIdx.z;
  a += bz * sa;
  b += bz * sb;
  c += static_cast<size_t>(bz) * m * n;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;

  // As is stored k-major (As[kk][row]); the pad of 4 spreads the
  // transposing store over more banks
  __shared__ float As[BK][TILE + 4];
  __shared__ float Bs[BK][TILE];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      // a tile: 64 rows x 16 k, read along k
      const int row = e / BK;
      const int kk = e % BK;
      const int gi = i0 + row;
      const int gk = k0 + kk;
      As[kk][row] = (gi < m && gk < k)
                        ? repro::to_float(a[gi * ars + gk * acs])
                        : 0.f;
      // b tile: 16 k x 64 columns, read along the columns
      const int kb = e / TILE;
      const int col = e % TILE;
      const int gkb = k0 + kb;
      const int gj = j0 + col;
      Bs[kb][col] = (gkb < k && gj < n)
                        ? repro::to_float(b[gkb * brs + gj * bcs])
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) bv[cc] = Bs[kk][tx + 16 * cc];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[r][cc] = fmaf(av[r], bv[cc], acc[r][cc]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx + 16 * cc;
      if (i < m && j < n)
        c[static_cast<size_t>(i) * n + j] = repro::from_float<T>(acc[r][cc]);
    }
  }
}

}  // namespace

extern "C" int repro_mm_simt(const void* a, const void* b, void* c,
                             int is_bf16, int batch, int m, int n, int k,
                             long long sa, long long ars, long long acs,
                             long long sb, long long brs, long long bcs,
                             void* stream) {
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    mm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
        m, n, k, sa, ars, acs, sb, brs, bcs);
  } else {
    mm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), m, n, k, sa, ars, acs, sb, brs, bcs);
  }
  return repro::launch_status();
}
