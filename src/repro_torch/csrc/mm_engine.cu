// Batched c = a @ b on the tensor cores with an fp32 accumulator; c takes
// a's dtype (fp32 or bf16, rounded once from the accumulator).
//
// Replaces the TPU kernel repro/kernels/mm_engine.py::mm_engine (body
// _mm_kernel): 128^3 VMEM tiles with a stationary fp32 accumulator, shapes
// padded to block multiples by ops._mm_kernel_impl.  Here the mainloop is
// the shared block-tile core (gemm_tile.cuh): a cp.async ring of 32-deep
// panels, 3xTF32 mma.sync for fp32 operands (fp32-grade sums), one bf16
// mma.sync for bf16.  The ragged edges are zero-filled by the copies and
// masked on the store, so nothing is padded or copied.
//
// a is (B, m, k) and b is (B, k, n).  Copies run along one of each
// operand's last two dims, named by a flag: a_kmajor = 0 for copies along
// k (a row-major a), 1 for copies along m (a transposed view); b_kmajor = 1
// for copies along n (a row-major b), 0 along k (a transposed one).
// a_step / b_step are the strides along the copied dim (1 for a dense
// operand; a strided view, such as every other column, or 0 for an
// expanded one, takes one element a copy), lda / ldb the other stride,
// sa / sb the batch strides (0 shares an operand across the batch),
// a_vec / b_vec the elements a copy moves (the wrapper picks 16, 8 or 4
// bytes from the alignment, one element where the step is not 1).  A
// product with a step other than 1 runs on the tile's STRIDED instances;
// the others keep the unit-stride addressing.  c is (B, m, n), contiguous.
//
// Two tiles, chosen by the wrapper from n:
//   narrow (n <= 32): 64 x 32 tiles of 4 warps, a 4-stage ring.  The
//     projection (70000, 784) @ (784, 32) is bound by the bytes of a, read
//     once: 220 MB, 0.068 ms at 3.35 TB/s; no thread computes a masked
//     column, and b (100 KB) is read from L2 by every block.
//   wide: 128 x 128 tiles of 8 warps, a 3-stage ring, for the square and
//     batched products (U = A V, the rotation datapath); 32 x (2048 x 256)
//     @ (256 x 256) is 8.6 GFLOP, 0.052 ms of 3xTF32 work at 495 TFLOP/s.
// mma.sync reaches part of the tensor rate that wgmma with TMA would.
#include "gemm_tile.cuh"

namespace {

using repro::gemm::Operand;
using Narrow = repro::gemm::Tile<64, 32, 32, 2, 2, 4, 3>;
using Wide = repro::gemm::Tile<128, 128, 32, 2, 4, 3, 2>;

struct Args {
  const void* a;
  const void* b;
  void* c;
  int batch, m, n, k;
  long long sa, lda, a_step;
  int a_vec;
  long long sb, ldb, b_step;
  int b_vec;
  cudaStream_t stream;
};

template <typename T, class Cfg, bool A_KMAJOR, bool B_KMAJOR, bool STRIDED>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
          T* __restrict__ c, int m, int n, int k, long long sa,
          long long lda, long long a_step, int a_vec, long long sb,
          long long ldb, long long b_step, int b_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bz = blockIdx.z;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * Cfg::BN;
  const Operand<T> A{a + bz * sa, lda, m, m0, a_vec, a_step};
  const Operand<T> B{b + bz * sb, ldb, n, n0, b_vec, b_step};
  float acc[Cfg::MT][Cfg::NT][4];
  repro::gemm::mainloop<T, Cfg, A_KMAJOR, B_KMAJOR, STRIDED>(acc, A, B, 0, k,
                                                            smem);

  int wm0, wn0;
  repro::gemm::warp_origin<Cfg>(wm0, wn0);
  const int g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  T* cb = c + static_cast<size_t>(bz) * m * n;
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + wm0 + mt * 16 + g + 8 * (e / 2);
        const int j = n0 + wn0 + nt * 8 + 2 * t + e % 2;
        if (i < m && j < n)
          cb[static_cast<size_t>(i) * n + j] =
              repro::from_float<T>(acc[mt][nt][e]);
      }
}

template <typename T, class Cfg, bool A_KMAJOR, bool B_KMAJOR, bool STRIDED>
int launch(const Args& x) {
  constexpr size_t bytes =
      repro::gemm::smem_bytes<T, Cfg, A_KMAJOR, B_KMAJOR>();
  auto kernel = mm_kernel<T, Cfg, A_KMAJOR, B_KMAJOR, STRIDED>;
  const int err = repro::allow_smem(kernel, bytes);
  if (err) return err;
  const dim3 grid((x.m + Cfg::BM - 1) / Cfg::BM, (x.n + Cfg::BN - 1) / Cfg::BN,
                  x.batch);
  kernel<<<grid, Cfg::THREADS, bytes, x.stream>>>(
      static_cast<const T*>(x.a), static_cast<const T*>(x.b),
      static_cast<T*>(x.c), x.m, x.n, x.k, x.sa, x.lda, x.a_step, x.a_vec,
      x.sb, x.ldb, x.b_step, x.b_vec);
  return repro::launch_status();
}

template <typename T, class Cfg, bool STRIDED>
int by_layout(const Args& x, int a_kmajor, int b_kmajor) {
  if (a_kmajor)
    return b_kmajor ? launch<T, Cfg, true, true, STRIDED>(x)
                    : launch<T, Cfg, true, false, STRIDED>(x);
  return b_kmajor ? launch<T, Cfg, false, true, STRIDED>(x)
                  : launch<T, Cfg, false, false, STRIDED>(x);
}

template <typename T, class Cfg>
int by_step(const Args& x, int a_kmajor, int b_kmajor) {
  return x.a_step != 1 || x.b_step != 1
             ? by_layout<T, Cfg, true>(x, a_kmajor, b_kmajor)
             : by_layout<T, Cfg, false>(x, a_kmajor, b_kmajor);
}

template <typename T>
int by_tile(const Args& x, int narrow, int a_kmajor, int b_kmajor) {
  return narrow ? by_step<T, Narrow>(x, a_kmajor, b_kmajor)
                : by_step<T, Wide>(x, a_kmajor, b_kmajor);
}

}  // namespace

extern "C" int repro_mm(const void* a, const void* b, void* c, int is_bf16,
                        int narrow, int batch, int m, int n, int k,
                        long long sa, long long lda, long long a_step,
                        int a_kmajor, int a_vec, long long sb, long long ldb,
                        long long b_step, int b_kmajor, int b_vec,
                        void* stream) {
  const Args x{a,  b,   c,      batch, m,     n,      k,
               sa, lda, a_step, a_vec, sb,    ldb,    b_step,
               b_vec, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? by_tile<__nv_bfloat16>(x, narrow, a_kmajor, b_kmajor)
                 : by_tile<float>(x, narrow, a_kmajor, b_kmajor);
}
