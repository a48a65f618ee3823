// Gram matrix C = X^T X over a batch: (B, m, n) -> (B, n, n), fp32 out.
//
// Replaces the TPU kernel repro/kernels/fused.py::fused_covariance (body
// _cov_kernel), which streams row panels past an (n, n) accumulator that
// stays in VMEM.  On Hopper no block can hold a 784 x 784 fp32 accumulator,
// and the grid runs in parallel, so the work is cut the other way:
//
//   * each block owns one 64 x 64 output tile of the upper triangle
//     (tile row <= tile column) and writes it and its mirror; the lower
//     triangle costs no arithmetic, and C comes out exactly symmetric;
//   * the block loops over its share of the m samples in 16-row panels
//     staged through shared memory; each thread keeps a 4 x 4 fp32
//     accumulator in registers (fmaf, no tensor cores: under the fp32
//     policy tensor cores would mean TF32, which breaks the 1e-5 budget);
//   * bf16 operands (bf16_fp32acc policy) are widened to float on load;
//   * at n = 784 there are only 91 upper tiles for 132 SMs, so the m axis
//     is split across blockIdx.y into `splits` fp32 partial Grams, summed
//     in a fixed order by cov_reduce (deterministic, no atomics).
//
// Bound: m * n^2 FMA-pairs = 2 * m * n^2 / 2 flops on the upper triangle;
// at MNIST-28x28 width (70000 x 784) that is 43 GFLOP on the CUDA cores
// (67 TFLOP/s fp32), i.e. compute-bound at about 0.64 ms.  This simple
// SIMT tiling reaches a fraction of that; wgmma is not an option at fp32.
#include "common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int m, int n,
            int rows_per_split, int tiles) {
  // decode the upper-triangle tile (ti <= tj) from the linear block index
  int t = blockIdx.x;
  int ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const T* xb = x + static_cast<size_t>(b) * m * n;
  float* ob = out + (static_cast<size_t>(split) * gridDim.z + b) *
                        static_cast<size_t>(n) * n;
  const int k_begin = split * rows_per_split;
  const int k_end = min(m, k_begin + rows_per_split);

  __shared__ float As[BK][TILE];
  __shared__ float Bs[BK][TILE];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int i0 = ti * TILE;
  const int j0 = tj * TILE;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
      const int kk = e / TILE;
      const int col = e % TILE;
      const int row = k0 + kk;
      const bool ok = row < k_end;
      const int ci = i0 + col;
      const int cj = j0 + col;
      const T* xr = xb + static_cast<size_t>(row) * n;
      As[kk][col] = (ok && ci < n) ? repro::to_float(xr[ci]) : 0.f;
      Bs[kk][col] = (ok && cj < n) ? repro::to_float(xr[cj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < n && j < n) {
        ob[static_cast<size_t>(i) * n + j] = acc[r][c];
        if (ti != tj) ob[static_cast<size_t>(j) * n + i] = acc[r][c];
      }
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial,
                              float* __restrict__ out, long long count,
                              int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = partial[i];
    for (int p = 1; p < splits; ++p) s += partial[p * count + i];
    out[i] = s;
  }
}

}  // namespace

// out holds splits * batch * n * n floats: with splits == 1 it is the Gram
// itself, otherwise the partials that repro_cov_reduce sums.
extern "C" int repro_cov_gram(const void* x, int x_is_bf16, float* out,
                              int batch, int m, int n, int splits,
                              int rows_per_split, void* stream) {
  const int tiles = (n + TILE - 1) / TILE;
  const dim3 grid(tiles * (tiles + 1) / 2, splits, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    gram_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), out, m, n, rows_per_split,
        tiles);
  } else {
    gram_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), out, m, n, rows_per_split, tiles);
  }
  return repro::launch_status();
}

extern "C" int repro_cov_reduce(const float* partial, float* out,
                                long long count, int splits, void* stream) {
  const int threads = 256;
  long long blocks = (count + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  reduce_kernel<<<static_cast<int>(blocks), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(partial, out, count,
                                                       splits);
  return repro::launch_status();
}
