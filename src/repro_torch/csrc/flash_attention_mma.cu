// Forward attention in bf16 on the tensor cores: q (BH, Sq, D), k/v
// (BH, Skv, D) of bf16 -> out (BH, Sq, D) in bf16; fp32 scores, row max m,
// row sum l and accumulator; any D <= 128, any base alignment.  The
// wrapper sends every bf16 prefill (Sq > 16) here; fp32 prefill goes to
// flash_attention_tf32.cu, Sq <= 16 to flash_decode.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for bf16 prefill.  FA2-style: one block of four
// warps owns one (bh, 64-row q tile); each warp owns 16 q rows and keeps
// their m, l and output accumulator in registers while 64-row K/V tiles
// stream past:
//
//   * Q is copied once into shared memory; K and V tiles go through a
//     two-stage ring, filled with cp.async copies while the previous tile
//     is computed.  A copy moves `vec` bf16: 8, 4 or 2 (16, 8 or 4 bytes),
//     the most that divides D and to which every base is aligned (the
//     wrapper's copy_elems; rows are D and batches Sq D or Skv D elements
//     apart, so dividing D is enough), or one element copied synchronously.
//     A row in shared memory is D rounded up to 16 (DP), plus 8 bf16 of
//     padding: its stride is an odd multiple of 16 bytes, so the eight rows
//     an ldmatrix reads hit all 32 banks once.  Rows past Sq or Skv and
//     the columns in [D, DP) are zero-filled by the copies themselves
//     (source size 0; vec divides D, so no copy straddles D); nothing is
//     padded in device memory, and zero columns add exactly zero to Q K^T.
//   * S = Q K^T is mma.sync m16n8k16 with bf16 operands and fp32 sums
//     (bf16 products are exact in fp32; only the order of the sums differs
//     from the plain version).  Scale, mask, row max, exp2, row sum and the
//     rescale stay fp32 in registers, in log2 units (score * scale *
//     log2 e); a row's four lanes reduce with quad shuffles.
//   * P V keeps fp32 accuracy: P is split into P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), and both products go into the same fp32
//     accumulator.  Rounding P once to bf16 gives errors of about
//     2^-9 / sqrt(Skv) on outputs of about 1 / sqrt(Skv), which break the
//     contract of one bf16 ulp + 2e-5 against the fp32 plain version; the
//     split keeps about 16 bits of P.
//   * The output is stored a column pair at a time where vec >= 2 (D even
//     and out 4-byte aligned), else an element at a time; nothing past D
//     is written.
//
// Masking follows the dense oracle (kernels/ref.py::flash_attention): a
// causal score above the diagonal is -1e30 (a row that sees no key gets
// the mean of all Skv values, as there) and keys at or past Skv take no
// part.  K/V tiles wholly above the diagonal are skipped only when every
// row of the q tile sees key 0 (their weights are then exactly zero).
// The denominator is max(l, 1e-30).
//
// Bound: causal prefill at BH 16, S 4096, D 128 is 4 BH D S (S + 1) / 2 =
// 68.7 GFLOP, 0.0695 ms at the 989 TFLOP/s bf16 dense rate.  This kernel
// issues 1.5x those multiply-adds (the P split doubles P V) on mma.sync,
// which reaches part of the wgmma rate; wgmma with TMA is later work.  At
// D 20 (padded to 32) the work is 0.67 GFLOP and the bytes 2.6 MB: a
// small call whose time is mostly launch and the K/V walk's latency.
#include <math.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;    // K/V ring depth: one tile in flight ahead
constexpr float kMasked = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

// bf16 elements per shared-memory row for a head dim padded to DP
__host__ __device__ constexpr int row_stride(int dp) { return dp + 8; }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * row_stride(DP) * (BQ + 2 * STAGES * BK);
}

using repro::gemm::copy_rows;
using repro::gemm::cp_async_commit;
using repro::gemm::cp_async_wait;
using repro::gemm::row_copy;
using repro::gemm::RowCopy;
using repro::gemm::smem_addr;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b for a 16 x 16 bf16 tile a (row) and a 16 x 8 bf16 tile b (col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) -> packed bf16 hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half, as the mma fragment wants the lower column there
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                    x1 - __high2float(h)));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int sq,
                 int skv, int d, int vec, float scale_log2,
                 int causal, int q_offset) {
  constexpr int STRIDE = row_stride(DP);
  constexpr int KSTEPS = DP / 16;  // 16-wide steps over the head dim
  constexpr int NT = DP / 8;       // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * STRIDE;
  bf16* Vs = Ks + STAGES * BK * STRIDE;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const int bh = blockIdx.y;
  // the last q tiles see the most keys under a causal mask: start them
  // first so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const bf16* qb = q + static_cast<size_t>(bh) * sq * d;
  const bf16* kb = k + static_cast<size_t>(bh) * skv * d;
  const bf16* vb = v + static_cast<size_t>(bh) * skv * d;

  int kv_end = skv;
  if (causal && q0 + q_offset >= 0) {
    const long long last = static_cast<long long>(min(BQ, sq - q0)) + q0 +
                           q_offset;  // last visible key + 1
    kv_end = static_cast<int>(min(static_cast<long long>(skv), last));
  }
  const int n_tiles = (kv_end + BK - 1) / BK;

  // each 64-row tile: vec bf16 a copy, zeros past Sq / Skv and from d on
  const RowCopy plan = row_copy<bf16, THREADS>(DP, d, vec);
  copy_rows<BQ, STRIDE>(Qs, qb, q0, sq, d, plan);
  copy_rows<BK, STRIDE>(Ks, kb, 0, skv, d, plan);
  copy_rows<BK, STRIDE>(Vs, vb, 0, skv, d, plan);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  // per-lane ldmatrix offsets (elements) inside a tile
  const int a_off = (warp * 16 + lane % 16) * STRIDE + (lane / 16) * 8;
  const int k_off = (lane % 8 + (lane / 16) * 8) * STRIDE + (lane / 8 % 2) * 8;
  const int v_off = (lane % 8 + (lane / 8 % 2) * 8) * STRIDE + (lane / 16) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % STAGES;
    if (j + 1 < n_tiles) {  // the next tile streams in while this one runs
      const int next = (j + 1) % STAGES;
      copy_rows<BK, STRIDE>(Ks + next * BK * STRIDE, kb, (j + 1) * BK, skv,
                            d, plan);
      copy_rows<BK, STRIDE>(Vs + next * BK * STRIDE, vb, (j + 1) * BK, skv,
                            d, plan);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * STRIDE;
    const bf16* Vt = Vs + stage * BK * STRIDE;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 tiles of 16 x 8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(Qs + a_off + kk * 16));
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {  // 16 keys a step
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(Kt + k_off + nn * 16 * STRIDE + kk * 16));
        mma_bf16(s[2 * nn], a, b[0], b[1]);
        mma_bf16(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // scale and mask (log2 units), then the online softmax of rows
    // row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
    float tile_max[2] = {-INFINITY, -INFINITY};  // every tile has a live key
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * BK + n * 8 + 2 * t + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        float val = s[n][e] * scale_log2;
        if (causal && row + q_offset < col) val = kMasked;
        if (col >= skv) val = -INFINITY;  // no key: weight exactly 0
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
    for (int n = 0; n < 8; ++n)
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

    // O += P_hi V + P_lo V, 16 keys a step; S's accumulator tiles are
    // already P's A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {  // 16 output columns a step
        uint32_t b[4];
        ldmatrix_x4_trans(b,
                          smem_addr(Vt + v_off + kk * 16 * STRIDE + nn * 16));
        mma_bf16(acc[2 * nn], ph, b[0], b[1]);
        mma_bf16(acc[2 * nn], pl, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], ph, b[2], b[3]);
        mma_bf16(acc[2 * nn + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // column pairs where vec >= 2 (d even, out 4-byte aligned), else single
  // elements; nothing at or past d is written
  bf16* ob = out + static_cast<size_t>(bh) * sq * d;
  const bool pairs = vec >= 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      const float o0 = acc[n][2 * r] / denom;
      const float o1 = acc[n][2 * r + 1] / denom;
      if (pairs) {
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o0, o1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(o0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(o1);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int skv, int d, int vec, float scale, int causal,
           int q_offset, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<DP>();
  const int err = repro::allow_smem(flash_mma_kernel<DP>, bytes);
  if (err) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_mma_kernel<DP><<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, skv, d, vec,
      scale * kLog2e, causal, q_offset);
  return repro::launch_status();
}

}  // namespace

// q (bh, sq, d), k / v (bh, skv, d), out (bh, sq, d); all bf16 and
// contiguous, 1 <= d <= 128; vec = bf16 a copy (8, 4, 2 or 1), which d
// and the alignment of q, k, v and out must allow.
extern "C" int repro_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int sq, int skv, int d, int vec,
                                         float scale, int causal,
                                         int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((vec != 1 && vec != 2 && vec != 4 && vec != 8) || d % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + 15) / 16) {
#define REPRO_FA_MMA_CASE(KC)                                               \
  case KC:                                                                  \
    return launch<16 * KC>(q, k, v, out, bh, sq, skv, d, vec, scale,       \
                           causal, q_offset, s);
    REPRO_FA_MMA_CASE(1)
    REPRO_FA_MMA_CASE(2)
    REPRO_FA_MMA_CASE(3)
    REPRO_FA_MMA_CASE(4)
    REPRO_FA_MMA_CASE(5)
    REPRO_FA_MMA_CASE(6)
    REPRO_FA_MMA_CASE(7)
    REPRO_FA_MMA_CASE(8)
#undef REPRO_FA_MMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
