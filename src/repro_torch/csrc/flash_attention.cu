// Forward attention with an online softmax: q (BH, Sq, D), k/v (BH, Skv, D)
// of bf16 -> out (BH, Sq, D) in bf16; fp32 scores, row max m, row sum l and
// accumulator; D <= 128.  The wrapper sends here the bf16 prefill that the
// tensor-core kernel does not take (D % 8 != 0 or rows not 16-byte
// aligned); fp32 prefill goes to flash_attention_tf32.cu, Sq <= 16 to
// flash_decode.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): a (bh, q block, kv block) grid whose kv dimension
// runs in order with m, l and acc stationary in VMEM.  Here one block of
// 256 threads owns one (bh, 64-row q tile) and loops over 64-row K/V tiles
// itself, so m, l and acc stay in registers for the whole stream:
//
//   * Q, K and V tiles are staged in shared memory as fp32 (rows padded by
//     one float, so the column walks of Q K^T are free of bank conflicts);
//     P = exp(S - m) reuses K's buffer for the P V product;
//   * thread (ty, tx) of a 16 x 16 grid holds rows ty + 16 r (r < 4), score
//     columns tx + 16 c (c < 4) and output columns tx + 16 c (c < D / 16);
//     a row's 16 threads all-reduce its max and sum with butterfly
//     shuffles, which give every lane the same bits;
//   * fp32 FMAs on the CUDA cores, no tensor cores.
//
// Masking follows the dense oracle (kernels/ref.py::flash_attention), not
// the TPU wrapper's padding: a causal score above the diagonal is -1e30
// and keys at or past the true Skv take no part at all, so any Skv works
// and nothing is padded.  K/V tiles wholly above the diagonal are skipped
// when every row of the q tile sees key 0 (then their weights are exactly
// zero).  The denominator is max(l, 1e-30) and the default scale D^-1/2
// (chosen by the wrapper).
//
// Bound: causal prefill at BH 16, S 1024, D 20 does 4 BH D S (S + 1) / 2
// = 0.67 GFLOP, 0.0007 ms at the 989 TFLOP/s bf16 tensor rate this kernel
// does not use; reading q, k, v and writing out (2.6 MB) takes 0.0008 ms.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// shared memory: Q (BQ x qs), K / P (BK x kps), V (BK x 16 DC)
__host__ __device__ constexpr int q_stride(int d) { return d + 1; }
__host__ __device__ constexpr int kp_stride(int d) {
  return d + 1 > BK + 1 ? d + 1 : BK + 1;
}

template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int d, float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  constexpr int VS = 16 * DC;  // V row stride, zero past column d
  const int qs = q_stride(d);
  const int kps = kp_stride(d);
  float* Qs = smem;
  float* KPs = Qs + BQ * qs;
  float* Vs = KPs + BK * kps;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* qb = q + static_cast<size_t>(bh) * sq * d;
  const T* kb = k + static_cast<size_t>(bh) * skv * d;
  const T* vb = v + static_cast<size_t>(bh) * skv * d;

  for (int e = threadIdx.x; e < BQ * d; e += THREADS) {
    const int r = e / d;
    const int col = e % d;
    Qs[r * qs + col] = q0 + r < sq
        ? repro::to_float(qb[static_cast<size_t>(q0 + r) * d + col]) : 0.f;
  }
  // V's columns d..VS-1 stay zero: the P V loop reads them unmasked
  for (int e = threadIdx.x; e < BK * (VS - d); e += THREADS) {
    Vs[(e / (VS - d)) * VS + d + e % (VS - d)] = 0.f;
  }

  // the keys this tile must visit
  int kv_end = skv;
  const int rows_here = min(BQ, sq - q0);
  if (causal && q0 + q_offset >= 0) {
    const long long last = static_cast<long long>(q0) + rows_here - 1 +
                           q_offset + 1;
    kv_end = static_cast<int>(min(static_cast<long long>(skv), last));
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the last tile's P and V are no longer read
    for (int e = threadIdx.x; e < BK * d; e += THREADS) {
      const int r = e / d;
      const int col = e % d;
      const bool live = k0 + r < skv;
      const size_t g = static_cast<size_t>(k0 + r) * d + col;
      KPs[r * kps + col] = live ? repro::to_float(kb[g]) : 0.f;
      Vs[r * VS + col] = live ? repro::to_float(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(ty + 16 * r) * qs + dd];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = KPs[(tx + 16 * c) * kps + dd];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r + q_offset;
      float tile_max = -INFINITY;  // every tile has a live key: k0 < skv
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        float val = s[r][c] * scale;
        if (causal && row < col) val = kNegInf;
        if (col >= skv) val = -INFINITY;  // no key: weight exactly 0
        s[r][c] = val;
        tile_max = fmaxf(tile_max, val);
      }
      const float m_new = fmaxf(m[r], row_max16(tile_max));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      alpha[r] = expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + row_sum16(sum);
      m[r] = m_new;
    }

    __syncthreads();  // every thread is done reading K
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        KPs[(ty + 16 * r) * kps + tx + 16 * c] = s[r][c];
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha[r];
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = KPs[(ty + 16 * r) * kps + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * VS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  T* ob = out + static_cast<size_t>(bh) * sq * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        ob[static_cast<size_t>(row) * d + col] =
            repro::from_float<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int skv, int d, float scale, int causal, int q_offset,
           cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * (BQ * q_stride(d) + BK * kp_stride(d) + BK * 16 * DC);
  const int err = repro::allow_smem(flash_kernel<T, DC>, bytes);
  if (err) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<T, DC><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, scale,
      causal, q_offset);
  return repro::launch_status();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh,
             int sq, int skv, int d, float scale, int causal, int q_offset,
             cudaStream_t s) {
  switch ((d + 15) / 16) {
#define REPRO_FA_CASE(DC)                                                  \
  case DC:                                                                 \
    return launch<T, DC>(q, k, v, out, bh, sq, skv, d, scale, causal,      \
                         q_offset, s);
    REPRO_FA_CASE(1)
    REPRO_FA_CASE(2)
    REPRO_FA_CASE(3)
    REPRO_FA_CASE(4)
    REPRO_FA_CASE(5)
    REPRO_FA_CASE(6)
    REPRO_FA_CASE(7)
    REPRO_FA_CASE(8)
#undef REPRO_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k / v (bh, skv, d), out (bh, sq, d); all bf16 and
// contiguous, 1 <= d <= 128.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int sq, int skv, int d, float scale,
                                     int causal, int q_offset, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, scale, causal,
                                 q_offset, static_cast<cudaStream_t>(stream));
}
