// The block-tile GEMM mainloop shared by the MM-Engine (mm_engine.cu) and
// the Gram kernel (covariance.cu): acc[BM x BN] += A[m0.., k] B[k, n0..]
// over a range of k, with fp32 accumulators in registers.  The copies
// (copy_chunk, the cp.async groups, the row copy of row_copy / copy_rows)
// and the tf32 split also serve the flash prefill kernels.
//
// Operands.  Each operand is an (extent x k) panel, A along m and B along
// n, stored in device memory; copies run along one of its two dims, the
// copied dim, `step` elements apart along it (1 for a dense operand):
//   KMAJOR = false  copied along k: element (mn, kk) at base[mn*ld + kk*step]
//   KMAJOR = true   copied along mn: element (mn, kk) at base[kk*ld + mn*step]
// (a row-major A is the first, a row-major B or either Gram operand, the
// rows of X, the second).  Tiles go through a STAGES-deep cp.async ring in
// shared memory, `vec` elements a copy: 16, 8 or 4 bytes as the base, the
// leading stride and the batch stride allow (bf16 may take single 2-byte
// elements, copied synchronously).  An operand with step != 1 (a strided
// view, or 0 for an expanded one) takes one element a copy: a 4-byte
// cp.async for fp32, a synchronous element for bf16.  Only instances with
// STRIDED = true read `step`; the others address base + row*ld + col.  A copy that runs
// past the ragged edge reads only its live bytes and the rest is
// zero-filled (source size), so nothing is padded or copied in device
// memory and dead rows and columns add exactly zero.
//
// fp32 operands: mma.sync m16n8k8 with tf32 operands and fp32 sums, each
// fragment value x split in registers into hi = x rounded to tf32 (as
// cvt.rna.tf32.f32 rounds, done with two integer operations, which the
// card runs faster than two cvt) and lo = x - hi, three products per step
// into one k step's sum: lo*hi + hi*lo + hi*hi (lo*lo, about 2^-22 of the
// product, is dropped).  One tf32 product keeps 11 bits of each operand
// and breaks the fp32 policy's 1e-5 budget on Grams of a few thousand
// rows; the split keeps about 22.  Fragments come from shared memory by
// 32-bit loads; rows are padded by 4 floats (k-contiguous) or 8 floats
// (mn-contiguous), which makes each fragment load free of bank conflicts.
//
// bf16 operands: mma.sync m16n8k16 with bf16 operands and fp32 sums, one
// product (bf16 products are exact in fp32); fragments through ldmatrix
// (k-contiguous) or ldmatrix.trans (mn-contiguous), rows padded by 16
// bytes to an odd multiple of 16 bytes, free of bank conflicts.
//
// Either way the tensor core's own sums truncate, so a short run of k is
// summed from zero and then added to the accumulator in registers
// (add_step).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace gemm {

// BM x BN block tile of WM x WN warps, BK-deep k panels, STAGES-deep ring;
// MIN_BLOCKS goes to __launch_bounds__ (blocks an SM should hold)
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WTM = BM / WM, WTN = BN / WN;  // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;   // its mma tiles
  static_assert(WTM % 16 == 0 && WTN % 16 == 0,
                "a warp covers whole 16-row and 16-column steps");
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(BK % 16 == 0, "whole k16 steps");
};

template <typename T>
struct Operand {
  const T* base;  // this batch's operand
  long long ld;   // elements between stored rows
  int extent;     // live rows along m (A) or n (B)
  int mn0;        // the block's first row along m or n
  int vec;        // elements a copy: 16, 8 or 4 bytes, or one element
  long long step = 1;  // elements between neighbours along the copied dim
                       // (read where STRIDED; vec is 1 where it is not 1)
};

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// one operand's stage in shared memory
template <typename T, bool KMAJOR, int MN, int BK>
struct Panel {
  static constexpr int ROWS = KMAJOR ? BK : MN;
  static constexpr int COLS = KMAJOR ? MN : BK;
  static constexpr int PAD = sizeof(T) == 2 ? 8 : (KMAJOR ? 8 : 4);
  static constexpr int STRIDE = COLS + PAD;
  static constexpr int ELEMS = ROWS * STRIDE;
  static constexpr int LOG_COLS = ilog2(COLS);
  static_assert(COLS == 1 << LOG_COLS, "rows of a power of two");
  static_assert(STRIDE * sizeof(T) % 16 == 0, "16-byte aligned rows");
  __device__ __forceinline__ static int offset(int mn, int k) {
    return KMAJOR ? k * STRIDE + mn : mn * STRIDE + k;
  }
};

template <typename T, class Cfg, bool A_KMAJOR, bool B_KMAJOR>
constexpr size_t smem_bytes() {
  return sizeof(T) * Cfg::STAGES *
         (Panel<T, A_KMAJOR, Cfg::BM, Cfg::BK>::ELEMS +
          Panel<T, B_KMAJOR, Cfg::BN, Cfg::BK>::ELEMS);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (16, 8, 4 or 2) global -> shared, of which the first `live` are
// read and the rest zero-filled
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int bytes, int live) {
  const uint32_t d = smem_addr(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(live));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(live));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(live));
  } else {  // one bf16 element: cp.async copies no fewer than 4 bytes
    *static_cast<unsigned short*>(dst) =
        live ? *static_cast<const unsigned short*>(src) : 0;
  }
}

// A thread's share of copying rows of a (n_rows, d) matrix into shared
// memory rows `cols` wide (d rounded up), `vec` elements a copy with vec
// dividing d (the flash kernels' tiles): one column chunk, in every
// r_step-th row from r0; threads past r_step * chunks copy nothing.
struct RowCopy {
  int r0, r_step, col, bytes, live_bytes;
  bool active;
};

template <typename T, int THREADS>
__device__ __forceinline__ RowCopy row_copy(int cols, int d, int vec) {
  const int chunks = cols / vec;  // at most THREADS
  RowCopy p;
  p.r_step = THREADS / chunks;
  p.active = threadIdx.x < p.r_step * chunks;
  p.r0 = threadIdx.x / chunks;
  p.col = threadIdx.x % chunks * vec;
  p.bytes = vec * static_cast<int>(sizeof(T));
  p.live_bytes = p.col < d ? p.bytes : 0;  // no copy straddles d
  return p;
}

// rows r_first .. r_first + ROWS - 1 of a (n_rows, d) matrix into rows
// STRIDE elements apart; rows past n_rows and columns past d become zeros.
// d is the stride between rows; the plan's d (row_copy) the live columns,
// which may be fewer (the selective scan's column tile of a wider matrix).
// BYTES and R_STEP, where not 0, are the plan's copy size and row step
// known at compile time: the copies then unroll into straight-line code.
template <int ROWS, int STRIDE, int BYTES = 0, int R_STEP = 0, typename T>
__device__ __forceinline__ void copy_rows(T* s, const T* g, int r_first,
                                          int n_rows, int d,
                                          const RowCopy& p) {
  if (!p.active) return;
  auto copy = [&](int r) {
    const int gr = r_first + r;
    const int live = gr < n_rows ? p.live_bytes : 0;
    const T* src = live ? g + static_cast<size_t>(gr) * d + p.col : g;
    copy_chunk(s + r * STRIDE + p.col, src, BYTES ? BYTES : p.bytes, live);
  };
  if constexpr (R_STEP > 0) {
#pragma unroll
    for (int i = 0; i < (ROWS + R_STEP - 1) / R_STEP; ++i)
      if (ROWS % R_STEP == 0 || p.r0 + i * R_STEP < ROWS)
        copy(p.r0 + i * R_STEP);
  } else {
    for (int r = p.r0; r < ROWS; r += p.r_step) copy(r);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one stage of one operand: the k range [k0, k0 + BK) of rows mn0 ..
// mn0 + MN - 1, dead elements (past extent or k_end) zero-filled.  A row
// has at most THREADS copies, so each thread keeps one column and steps
// down the rows.
template <typename T, bool KMAJOR, int MN, int BK, int THREADS,
          bool STRIDED = false>
__device__ __forceinline__ void load_panel(T* s, const Operand<T>& op,
                                           int k0, int k_end) {
  using P = Panel<T, KMAJOR, MN, BK>;
  static_assert(P::COLS <= THREADS, "a row's copies fit in the block");
  const int shift = __ffs(op.vec) - 1;  // vec is a power of two
  const int row_shift = P::LOG_COLS - shift;  // copies a row, as a shift
  const int c = (threadIdx.x & ((1 << row_shift) - 1)) << shift;
  const int r0 = threadIdx.x >> row_shift;
  const int r_step = THREADS >> row_shift;
  const int bytes = op.vec * static_cast<int>(sizeof(T));
  const int gcol = KMAJOR ? op.mn0 + c : k0 + c;
  const int col_end = KMAJOR ? op.extent : k_end;
  const int col_live =
      max(0, min(op.vec, col_end - gcol)) * static_cast<int>(sizeof(T));
  const int row_end = KMAJOR ? k_end : op.extent;
  int grow = (KMAJOR ? k0 : op.mn0) + r0;
  const T* src = op.base + static_cast<long long>(grow) * op.ld;
  if constexpr (STRIDED)
    src += gcol * op.step;
  else
    src += gcol;
  const long long src_step = static_cast<long long>(r_step) * op.ld;
  for (int r = r0; r < P::ROWS; r += r_step) {
    const int live = grow < row_end ? col_live : 0;
    copy_chunk(s + r * P::STRIDE + c, live ? src : op.base, bytes, live);
    grow += r_step;
    src += src_step;
  }
}

// x -> (hi, lo): hi = x rounded to tf32 (to nearest, ties away from zero,
// as cvt.rna does), lo = x - hi, which is exact.  lo goes to the tensor
// core as it is, which reads its top 19 bits: a truncation of at most
// 2^-21 of |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  }
}

// This lane's ldmatrix row address for four 8 x 8 matrices at (mn0, k0).
// A's fragment wants them as (mn 0-7, k 0-7), (mn 8-15, k 0-7),
// (mn 0-7, k 8-15), (mn 8-15, k 8-15); B's, two 8-column tiles, as
// (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
// A k-contiguous panel gives a matrix's rows along mn (no transpose), an
// mn-contiguous one along k (.trans).
template <typename P, bool KMAJOR, bool IS_A>
__device__ __forceinline__ uint32_t ldmatrix_addr(const __nv_bfloat16* s,
                                                  int mn0, int k0) {
  const int lane = threadIdx.x % 32;
  const int mat = lane / 8;
  const int j = lane % 8;
  const int mn_off = IS_A ? (mat % 2) * 8 : (mat / 2) * 8;
  const int k_off = IS_A ? (mat / 2) * 8 : (mat % 2) * 8;
  const int off = KMAJOR ? (k0 + k_off + j) * P::STRIDE + mn0 + mn_off
                         : (mn0 + mn_off + j) * P::STRIDE + k0 + k_off;
  return smem_addr(s + off);
}

// this warp's first row and column inside the block tile
template <class Cfg>
__device__ __forceinline__ void warp_origin(int& wm0, int& wn0) {
  const int warp = threadIdx.x / 32;
  wm0 = (warp / Cfg::WN) * Cfg::WTM;
  wn0 = (warp % Cfg::WN) * Cfg::WTN;
}

// The tensor core sums an mma's products and its accumulator input with
// truncation, not round-to-nearest: fed a growing accumulator, the
// truncations add up to a bias of about 1e-4 over 70000 samples.  So the
// products of a short run of k (one k8 step for tf32, one stage for bf16)
// are summed from zero and added to the accumulator in registers with a
// rounded fp32 add.
__device__ __forceinline__ void add_step(float (&acc)[4],
                                         const float (&step)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// acc += one stage: this warp's WTM x WTN tile over BK
template <class Cfg, bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void compute_stage(
    float (&acc)[Cfg::MT][Cfg::NT][4], const float* sa, const float* sb,
    int wm0, int wn0) {
  using PA = Panel<float, A_KMAJOR, Cfg::BM, Cfg::BK>;
  using PB = Panel<float, B_KMAJOR, Cfg::BN, Cfg::BK>;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; kk += 8) {
    uint32_t bh[Cfg::NT][2], bl[Cfg::NT][2];
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt) {
      const int n = wn0 + nt * 8 + g;
      split_tf32(sb[PB::offset(n, kk + t)], bh[nt][0], bl[nt][0]);
      split_tf32(sb[PB::offset(n, kk + t + 4)], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt) {
      const int m = wm0 + mt * 16 + g;
      uint32_t ah[4], al[4];
      split_tf32(sa[PA::offset(m, kk + t)], ah[0], al[0]);
      split_tf32(sa[PA::offset(m + 8, kk + t)], ah[1], al[1]);
      split_tf32(sa[PA::offset(m, kk + t + 4)], ah[2], al[2]);
      split_tf32(sa[PA::offset(m + 8, kk + t + 4)], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) {  // small products first
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(step, al, bh[nt]);
        mma_tf32(step, ah, bl[nt]);
        mma_tf32(step, ah, bh[nt]);
        add_step(acc[mt][nt], step);
      }
    }
  }
}

template <class Cfg, bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void compute_stage(
    float (&acc)[Cfg::MT][Cfg::NT][4], const __nv_bfloat16* sa,
    const __nv_bfloat16* sb, int wm0, int wn0) {
  using PA = Panel<__nv_bfloat16, A_KMAJOR, Cfg::BM, Cfg::BK>;
  using PB = Panel<__nv_bfloat16, B_KMAJOR, Cfg::BN, Cfg::BK>;
  constexpr int KS = Cfg::BK / 16;
  // B's fragments of the whole stage stay in registers while each 16-row
  // slice of A passes them; a slice's products over the stage are summed
  // from zero, then added to the accumulator (add_step)
  uint32_t bf[KS][Cfg::NT][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < Cfg::NT / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4<B_KMAJOR>(
          r, ldmatrix_addr<PB, B_KMAJOR, false>(sb, wn0 + np * 16, ks * 16));
      bf[ks][2 * np][0] = r[0];
      bf[ks][2 * np][1] = r[1];
      bf[ks][2 * np + 1][0] = r[2];
      bf[ks][2 * np + 1][1] = r[3];
    }
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt) {
    float step[Cfg::NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4];
      ldmatrix_x4<A_KMAJOR>(
          af, ldmatrix_addr<PA, A_KMAJOR, true>(sa, wm0 + mt * 16, ks * 16));
#pragma unroll
      for (int nt = 0; nt < Cfg::NT; ++nt) mma_bf16(step[nt], af, bf[ks][nt]);
    }
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt) add_step(acc[mt][nt], step[nt]);
  }
}

// The mainloop: acc = sum over k in [k_begin, k_end) of A(m, k) B(k, n)
// for this block's tile.  smem holds smem_bytes<T, Cfg, ...>() bytes.
// acc[mt][nt][e] is element (wm0 + mt*16 + g + 8*(e/2),
// wn0 + nt*8 + 2*t + e%2) of the tile, with wm0, wn0 from warp_origin.
// STRIDED reads each operand's step (the MM-Engine's strided layouts).
template <typename T, class Cfg, bool A_KMAJOR, bool B_KMAJOR,
          bool STRIDED = false>
__device__ __forceinline__ void mainloop(float (&acc)[Cfg::MT][Cfg::NT][4],
                                         const Operand<T>& a,
                                         const Operand<T>& b, int k_begin,
                                         int k_end, unsigned char* smem) {
  using PA = Panel<T, A_KMAJOR, Cfg::BM, Cfg::BK>;
  using PB = Panel<T, B_KMAJOR, Cfg::BN, Cfg::BK>;
  T* sa = reinterpret_cast<T*>(smem);
  T* sb = sa + Cfg::STAGES * PA::ELEMS;
  int wm0, wn0;
  warp_origin<Cfg>(wm0, wn0);
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int tiles =
      k_end > k_begin ? (k_end - k_begin + Cfg::BK - 1) / Cfg::BK : 0;

  auto load = [&](int tile) {
    const int stage = tile % Cfg::STAGES;
    const int k0 = k_begin + tile * Cfg::BK;
    load_panel<T, A_KMAJOR, Cfg::BM, Cfg::BK, Cfg::THREADS, STRIDED>(
        sa + stage * PA::ELEMS, a, k0, k_end);
    load_panel<T, B_KMAJOR, Cfg::BN, Cfg::BK, Cfg::THREADS, STRIDED>(
        sb + stage * PB::ELEMS, b, k0, k_end);
  };
#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();  // an empty group keeps the count in step
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<Cfg::STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and stage kt - 1 is free
    if (kt + Cfg::STAGES - 1 < tiles) load(kt + Cfg::STAGES - 1);
    cp_async_commit();
    const int stage = kt % Cfg::STAGES;
    compute_stage<Cfg, A_KMAJOR, B_KMAJOR>(acc, sa + stage * PA::ELEMS,
                                           sb + stage * PB::ELEMS, wm0, wn0);
  }
  cp_async_wait<0>();
}

}  // namespace gemm
}  // namespace repro
