// Forward attention in fp32 on the tensor cores: q (BH, Sq, D), k/v
// (BH, Skv, D) of fp32 -> out (BH, Sq, D) in fp32; fp32 scores, row max m,
// row sum l and accumulator; D <= 128.  The wrapper sends fp32 prefill
// (Sq > 16) here; bf16 prefill goes to flash_attention_mma.cu, Sq <= 16
// to flash_decode.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for fp32 prefill.  FA2-style: one block of eight
// warps owns one (bh, 128-row q tile); each warp owns 16 q rows and keeps
// their m, l and output accumulator (16 x D fp32) in registers while
// 32-row K/V tiles stream past:
//
//   * Q is copied once into shared memory; K and V tiles go through a
//     STAGES-deep cp.async ring (one barrier a tile).  Copies are 16 bytes
//     where D % 4 == 0 and the rows are 16-byte aligned, else 8 or 4 bytes
//     (the wrapper picks); rows past Sq or Skv and the columns from D up to
//     a multiple of 8 are zero-filled by the copy itself (source size), so
//     nothing is padded in device memory and zero columns add exactly
//     zero.
//   * S = Q K^T and O += P V are mma.sync m16n8k8 with tf32 operands and
//     three products per k8 step (gemm_tile.cuh: split_tf32, mma_tf32,
//     add_step): each fp32 operand x is split in registers into hi = x
//     rounded to tf32 and lo = x - hi, and lo*hi + hi*lo + hi*hi keep
//     about 22 bits of each product, where one tf32 product (11 bits)
//     breaks the 2e-5 fp32 contract.  The tensor core's own sums truncate
//     (to within an ulp of the sum it returns), so no large running sum
//     goes through it: in S = Q K^T each k8 step's hi*hi is summed from
//     zero and added to S in fp32 registers, while the two small products
//     (about 2^-11 of S) run through the tensor core in a chain of their
//     own, added to S at the end; P V is summed from zero over the tile's
//     32 keys (four k8 steps, 12 chained products) and then added to O.
//   * P goes from S's accumulator into P V without shared memory.  The
//     accumulator holds keys 2t and 2t + 1 in lane (g, t), and the tf32 A
//     fragment wants columns t and t + 4; P V sums over keys, so the k
//     index is relabelled (mma column t <-> key 2t, t + 4 <-> key 2t + 1)
//     and V's B fragment is read from rows 2t and 2t + 1 to match.
//   * Fragments come from shared memory as float2 pairs: within a k8 step
//     of Q K^T the head-dim index is relabelled the same way for Q and K
//     (mma column t <-> 2t, t + 4 <-> 2t + 1), so a0/a2, a1/a3 and b0/b1
//     are neighbours; in P V two output tiles share their loads (tile 2c,
//     column g <-> head dim 16c + 2g, tile 2c + 1 <-> 16c + 2g + 1), which
//     also puts four neighbouring outputs in a lane (one 16-byte store).
//     A row is D rounded up to 32 plus 8 floats for Q and K, plus 4 for V:
//     each half-warp's 8-byte loads then hit 32 distinct banks (Q and K:
//     row g, column 2t; V: rows 2t and 2t + 1, column 2g).
//   * Scale, mask, row max, exp2, row sum and the rescale stay fp32 in
//     registers, in log2 units (score * scale * log2 e); a row's four
//     lanes reduce with quad shuffles.
//
// Masking follows the dense oracle (kernels/ref.py::flash_attention): a
// causal score above the diagonal is -1e30 (a row that sees no key gets
// the mean of all Skv values, as there) and keys at or past Skv take no
// part.  K/V tiles wholly above the diagonal are skipped, by the block and
// by each warp, only when every row of the q tile sees key 0 (their
// weights are then exactly zero).  The denominator is max(l, 1e-30).
// Blocks run the heaviest causal q tiles first, across all heads.
//
// Bound: causal prefill at BH 16, S 4096, D 128 is 4 BH D S (S + 1) / 2 =
// 68.7 GFLOP: 1.026 ms at the 67 TFLOP/s fp32 CUDA-core rate; the three
// tf32 products are 206 GFLOP of tensor-core work, 0.416 ms at the
// 495 TFLOP/s tf32 dense rate, which mma.sync reaches only in part.  The
// splits, adds and the softmax run on the CUDA cores beside the tensor
// cores.  A wgmma version needs V transposed into K-major hi/lo planes in
// shared memory: later work.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using repro::gemm::add_step;
using repro::gemm::copy_rows;
using repro::gemm::cp_async_commit;
using repro::gemm::cp_async_wait;
using repro::gemm::mma_tf32;
using repro::gemm::row_copy;
using repro::gemm::RowCopy;
using repro::gemm::split_tf32;

constexpr int BQ = 128;      // q rows per block
constexpr int BK = 32;       // keys per K/V tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;    // K/V ring depth
constexpr int ST = BK / 8;   // 8-key score tiles = k8 steps of P V
constexpr float kMasked = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// floats per shared-memory row for a head dim padded to DP: 8 (mod 32)
// for Q and K, 4 (mod 32) for V
__host__ __device__ constexpr int qk_stride(int dp) {
  return (dp + 31) / 32 * 32 + 8;
}
__host__ __device__ constexpr int v_stride(int dp) {
  return (dp + 31) / 32 * 32 + 4;
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((BQ + STAGES * BK) * qk_stride(DP) +
                          STAGES * BK * v_stride(DP));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// c += lo_a hi_b + hi_a lo_b + hi_a hi_b (small products first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// the (hi, lo) tf32 B fragment of two fp32 values
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int bh_count, int sq, int skv, int d, int vec,
                  float scale_log2, int causal, int q_offset) {
  constexpr int QKS = qk_stride(DP);
  constexpr int VS = v_stride(DP);
  constexpr int KSTEPS = DP / 8;  // k8 steps over the head dim
  constexpr int NT = DP / 8;      // 8-wide output column tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QKS;
  float* Vs = Ks + STAGES * BK * QKS;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column
  // one block per (q tile, bh), the last q tiles (the most keys under a
  // causal mask) of every head first, so that the short ones fill the tail
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_qtiles - 1 - static_cast<int>(blockIdx.x) / bh_count) *
                 BQ;
  const float* qb = q + static_cast<size_t>(bh) * sq * d;
  const float* kb = k + static_cast<size_t>(bh) * skv * d;
  const float* vb = v + static_cast<size_t>(bh) * skv * d;

  // when every row of the tile sees key 0, keys past the last row's
  // diagonal have weight exactly 0: the block stops there, and a warp
  // skips the tiles past its own last row's diagonal
  const bool cut = causal && q0 + q_offset >= 0;
  int kv_end = skv;
  long long warp_last = LLONG_MAX;  // last key this warp's rows see
  if (cut) {
    const long long last = static_cast<long long>(min(BQ, sq - q0)) + q0 +
                           q_offset;  // last visible key + 1
    kv_end = static_cast<int>(min(static_cast<long long>(skv), last));
    warp_last = static_cast<long long>(q0) + warp * 16 + 15 + q_offset;
  }
  const int n_tiles = (kv_end + BK - 1) / BK;
  // the position of this warp's first row: a tile whose last key is not
  // past it needs no causal mask
  const long long warp_first_pos =
      static_cast<long long>(q0) + warp * 16 + q_offset;

  // cp.async groups: Q with tile 0, then one tile a group
  const RowCopy plan = row_copy<float, THREADS>(DP, d, vec);
  auto load_kv = [&](int tile) {
    const int stage = tile % STAGES;
    copy_rows<BK, QKS>(Ks + stage * BK * QKS, kb, tile * BK, skv, d, plan);
    copy_rows<BK, VS>(Vs + stage * BK * VS, vb, tile * BK, skv, d, plan);
  };
  copy_rows<BQ, QKS>(Qs, qb, q0, sq, d, plan);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();  // an empty group keeps the count in step
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float* Qw = Qs + (warp * 16 + g) * QKS + 2 * t;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();  // tile j has landed ...
    __syncthreads();  // ... for every thread, and tile j - 1 is done with
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();
    const int k0 = j * BK;
    if (k0 > warp_last) continue;  // every key here is above this warp
    const float* Kt = Ks + j % STAGES * BK * QKS;
    const float* Vt = Vs + j % STAGES * BK * VS;

    // S = Q K^T: 16 rows x BK keys a warp, ST tiles of 16 x 8; each k8
    // step's hi*hi summed from zero, then added to S; the small products
    // chained over the head dim apart, then added
    float s[ST][4], small[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      // head dims 8kk + 2t and + 1 play mma columns t and t + 4
      const float2 qa = ld2(Qw + kk * 8);            // row g
      const float2 qc = ld2(Qw + 8 * QKS + kk * 8);  // row g + 8
      uint32_t ah[4], al[4];
      split_tf32(qa.x, ah[0], al[0]);
      split_tf32(qc.x, ah[1], al[1]);
      split_tf32(qa.y, ah[2], al[2]);
      split_tf32(qc.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const float2 kv = ld2(Kt + (n * 8 + g) * QKS + kk * 8 + 2 * t);
        uint32_t bh_[2], bl_[2];
        split_pair(kv.x, kv.y, bh_, bl_);
        mma_tf32(small[n], al, bh_);
        mma_tf32(small[n], ah, bl_);
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(step, ah, bh_);
        add_step(s[n], step);
      }
    }
#pragma unroll
    for (int n = 0; n < ST; ++n) add_step(s[n], small[n]);

    // scale and mask (log2 units), then the online softmax of rows
    // row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
    const bool mask = (causal && k0 + BK - 1 > warp_first_pos) ||
                      k0 + BK > skv;
    float tile_max[2] = {-INFINITY, -INFINITY};  // a tile has a live key
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[n][e] * scale_log2;
        if (mask) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (causal && row + q_offset < col) val = kMasked;
          if (col >= skv) val = -INFINITY;  // no key: weight exactly 0
        }
        s[n][e] = val;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(tile_max[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V over the tile's keys, summed from zero, then added to O.
    // S's accumulator is P's A fragment with the k index relabelled: mma
    // column t is key 2t (s[n][0], s[n][2]), column t + 4 is key 2t + 1
    // (s[n][1], s[n][3]), and V's B fragment comes from rows 2t, 2t + 1
    uint32_t ph[ST][4], pl[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      split_tf32(s[n][0], ph[n][0], pl[n][0]);
      split_tf32(s[n][2], ph[n][1], pl[n][1]);
      split_tf32(s[n][1], ph[n][2], pl[n][2]);
      split_tf32(s[n][3], ph[n][3], pl[n][3]);
    }
    // output tiles 2c and 2c + 1 share their loads: column g of tile 2c
    // is head dim 16c + 2g, of tile 2c + 1 head dim 16c + 2g + 1
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      float ta[4] = {0.f, 0.f, 0.f, 0.f}, tb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const float* vp = Vt + (n * 8 + 2 * t) * VS + 16 * c + 2 * g;
        const float2 v0 = ld2(vp);       // key 2t
        const float2 v1 = ld2(vp + VS);  // key 2t + 1
        uint32_t bh_[2], bl_[2];
        split_pair(v0.x, v1.x, bh_, bl_);
        mma_3xtf32(ta, ph[n], pl[n], bh_, bl_);
        split_pair(v0.y, v1.y, bh_, bl_);
        mma_3xtf32(tb, ph[n], pl[n], bh_, bl_);
      }
      add_step(acc[2 * c], ta);
      add_step(acc[2 * c + 1], tb);
    }
    if (NT % 2) {  // a last, unpaired tile: head dims 8 (NT - 1) + g
      float ta[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const float* vq = Vt + (n * 8 + 2 * t) * VS + 8 * (NT - 1) + g;
        uint32_t bh_[2], bl_[2];
        split_pair(vq[0], vq[VS], bh_, bl_);
        mma_3xtf32(ta, ph[n], pl[n], bh_, bl_);
      }
      add_step(acc[NT - 1], ta);
    }
  }
  cp_async_wait<0>();

  // a lane holds head dims 16c + 4t .. + 3 of tiles 2c, 2c + 1 as
  // (2c, e), (2c + 1, e), (2c, e + 1), (2c + 1, e + 1) for e = 2r
  float* ob = out + static_cast<size_t>(bh) * sq * d;
  const bool wide = d % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = ob + static_cast<size_t>(row) * d;
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      const int col = 16 * c + 4 * t;
      const float o[4] = {acc[2 * c][2 * r] / denom,
                          acc[2 * c + 1][2 * r] / denom,
                          acc[2 * c][2 * r + 1] / denom,
                          acc[2 * c + 1][2 * r + 1] / denom};
      if (wide && col < d) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) orow[col + e] = o[e];
      }
    }
    if (NT % 2) {
      const int col = 8 * (NT - 1) + 2 * t;
      if (col < d) orow[col] = acc[NT - 1][2 * r] / denom;
      if (col + 1 < d) orow[col + 1] = acc[NT - 1][2 * r + 1] / denom;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out,
           int bh, int sq, int skv, int d, int vec, float scale, int causal,
           int q_offset, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<DP>();
  const long long blocks = static_cast<long long>((sq + BQ - 1) / BQ) * bh;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int err = repro::allow_smem(flash_tf32_kernel<DP>, bytes);
  if (err) return err;
  flash_tf32_kernel<DP><<<static_cast<unsigned>(blocks), THREADS, bytes, s>>>(
      q, k, v, out, bh, sq, skv, d, vec, scale * kLog2e, causal, q_offset);
  return repro::launch_status();
}

}  // namespace

// q (bh, sq, d), k / v (bh, skv, d), out (bh, sq, d); all fp32 and
// contiguous, 1 <= d <= 128; vec = floats a copy (4, 2 or 1), which d and
// the alignment of q, k and v must allow.
extern "C" int repro_flash_attention_tf32(const void* q, const void* k,
                                          const void* v, void* out, int bh,
                                          int sq, int skv, int d, int vec,
                                          float scale, int causal,
                                          int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 2 && vec != 4) || d % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch ((d + 7) / 8) {
#define REPRO_FA_TF32_CASE(KC)                                              \
  case KC:                                                                  \
    return launch<8 * KC>(qf, kf, vf, of, bh, sq, skv, d, vec, scale,       \
                          causal, q_offset, s);
    REPRO_FA_TF32_CASE(1)
    REPRO_FA_TF32_CASE(2)
    REPRO_FA_TF32_CASE(3)
    REPRO_FA_TF32_CASE(4)
    REPRO_FA_TF32_CASE(5)
    REPRO_FA_TF32_CASE(6)
    REPRO_FA_TF32_CASE(7)
    REPRO_FA_TF32_CASE(8)
    REPRO_FA_TF32_CASE(9)
    REPRO_FA_TF32_CASE(10)
    REPRO_FA_TF32_CASE(11)
    REPRO_FA_TF32_CASE(12)
    REPRO_FA_TF32_CASE(13)
    REPRO_FA_TF32_CASE(14)
    REPRO_FA_TF32_CASE(15)
    REPRO_FA_TF32_CASE(16)
#undef REPRO_FA_TF32_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
