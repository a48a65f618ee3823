// Gram matrix C = X^T X over a batch: (B, m, n) -> (B, n, n), fp32 out.
//
// Replaces the TPU kernel repro/kernels/fused.py::fused_covariance (body
// _cov_kernel), which streams row panels past an (n, n) accumulator that
// stays in VMEM.  On Hopper no block can hold a 784 x 784 fp32 accumulator,
// and the grid runs in parallel, so the work is cut the other way:
//
//   * each block owns one 128 x 128 output tile of the upper triangle
//     (tile row <= tile column) and writes it and its mirror; a diagonal
//     tile writes its upper half and mirrors that.  The lower triangle
//     costs no arithmetic, and C comes out exactly symmetric;
//   * the block runs the shared tile core (gemm_tile.cuh) over its share of
//     the m samples, with both operands the rows of X (contiguous along n,
//     so both fragments are read transposed): 3xTF32 mma.sync for fp32
//     operands, which keeps fp32-grade sums (one tf32 product would break
//     the fp32 policy's 1e-5 budget), and one bf16 mma.sync for bf16
//     operands (bf16_fp32acc policy; products exact in fp32);
//   * at n = 784 there are only 28 upper tiles, so the m axis is split
//     across blockIdx.y into `splits` fp32 partial Grams (about 2.5 MB
//     each at n = 784), summed in a fixed order by cov_reduce
//     (deterministic, no atomics).
//
// Bound: m * n^2 FMA-pairs = m * n * (n + 1) flops on the upper triangle;
// at MNIST-28x28 width (70000 x 784) that is 43 GFLOP, 0.64 ms on the CUDA
// cores (67 TFLOP/s fp32) and 0.26 ms of 3xTF32 work at 495 TFLOP/s; bf16,
// one product, 0.044 ms at 989 TFLOP/s.  mma.sync reaches part of the
// tensor rate that wgmma with TMA would.
#include "gemm_tile.cuh"

namespace {

using repro::gemm::Operand;
// bf16 stages are 64 deep: half the bytes of an fp32 row, and one
// accumulator flush (add_step) per 64 samples
template <typename T>
using GramTile =
    repro::gemm::Tile<128, 128, sizeof(T) == 2 ? 64 : 32, 2, 4, 3, 2>;

template <typename T, class Cfg = GramTile<T>>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
gram_kernel(const T* __restrict__ x, float* __restrict__ out, int m, int n,
            int rows_per_split, int tiles, int vec) {
  static_assert(Cfg::BM == Cfg::BN, "square tiles mirror onto each other");
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int k_begin = min(m, split * rows_per_split);
  const int k_end = min(m, k_begin + rows_per_split);
  const int i0 = ti * Cfg::BM;
  const int j0 = tj * Cfg::BN;
  // A(i, r) = X[r, i] and B(r, j) = X[r, j]: both read along n
  const Operand<T> A{xb, n, n, i0, vec};
  const Operand<T> B{xb, n, n, j0, vec};
  float acc[Cfg::MT][Cfg::NT][4];
  repro::gemm::mainloop<T, Cfg, true, true>(acc, A, B, k_begin, k_end, smem);

  int wm0, wn0;
  repro::gemm::warp_origin<Cfg>(wm0, wn0);
  const int g = threadIdx.x % 32 / 4;
  const int lt = threadIdx.x % 4;
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm0 + mt * 16 + g + 8 * (e / 2);
        const int j = j0 + wn0 + nt * 8 + 2 * lt + e % 2;
        // on a diagonal tile (i, j) and (j, i) come from different mma
        // lanes, which need not round alike: keep i <= j and mirror it
        if (i < n && j < n && i <= j) {
          ob[static_cast<size_t>(i) * n + j] = acc[mt][nt][e];
          ob[static_cast<size_t>(j) * n + i] = acc[mt][nt][e];
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

template <typename T>
int launch_gram(const void* x, float* out, int batch, int m, int n,
                int splits, int rows_per_split, int vec, cudaStream_t s) {
  using Cfg = GramTile<T>;
  constexpr size_t bytes = repro::gemm::smem_bytes<T, Cfg, true, true>();
  const int err = repro::allow_smem(gram_kernel<T>, bytes);
  if (err) return err;
  const int tiles = (n + Cfg::BM - 1) / Cfg::BM;
  const dim3 grid(tiles * (tiles + 1) / 2, splits, batch);
  gram_kernel<T><<<grid, Cfg::THREADS, bytes, s>>>(
      static_cast<const T*>(x), out, m, n, rows_per_split, tiles, vec);
  return repro::launch_status();
}

}  // namespace

// out holds splits * batch * n * n floats: with splits == 1 it is the Gram
// itself, otherwise the partials that repro_cov_reduce sums.  x is
// contiguous; vec is the elements a copy moves (16, 8 or 4 bytes as the
// base and n allow, or one bf16).
extern "C" int repro_cov_gram(const void* x, int x_is_bf16, float* out,
                              int batch, int m, int n, int splits,
                              int rows_per_split, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_gram<__nv_bfloat16>(x, out, batch, m, n, splits,
                                                rows_per_split, vec, s)
                   : launch_gram<float>(x, out, batch, m, n, splits,
                                        rows_per_split, vec, s);
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
