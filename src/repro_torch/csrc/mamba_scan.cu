// Selective scan (Mamba-1 SSM), forward:
//
//   x_t = exp(dt_t A) x_{t-1} + (dt_t u_t) B_t,   y_t = x_t . C_t + D u_t
//
// for u, dt (batch, L, D), A (D, N) fp32, B, C (batch, L, N), D_skip (D,)
// fp32; u, dt, B and C share one dtype (fp32 or bf16), y takes it; the
// state is fp32 (bf16 in the bf16-state instance below); N <= 16.  With a
// state_out (batch, D, N) fp32, the final state x_{L-1} is stored there as
// well (a model's prefill keeps it for decode); state_out may be null.
//
// A bf16-state instance (BF16_STATE, a model's ssm_dtype="bfloat16")
// keeps the state in bf16 and rounds (round to nearest even) where the
// reference's bf16 scan rounds: with r() a rounding to bf16,
//
//   a_t = r(exp(r(r(dt_t) r(A))))    b_t = r(r(r(dt_t) r(u_t)) r(B_t))
//   x_t = r(r(a_t x_{t-1}) + b_t)    y_t = x_t . r(C_t) + D u_t
//
// each product and sum of two bf16 values as the plain version forms it,
// r() of the fp32 product or sum, which is the correctly rounded bf16
// result (fp32's 24 bits are at least 2 x 8 + 2): here a packed bf16x2
// mul.rn or add.rn, two values an instruction, never contracted into an
// FMA; exp as expf (the fp32 exponential of the plain version, not
// ex2.approx) rounded by the packed convert; y summed in fp32 and D u on
// the unrounded u.  Each primitive is held to its plain counterpart at
// every input on the card (repro_scan_bf16_check).  The final state is
// stored in fp32 (bf16 values).
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan (body
// _scan_kernel): a (batch, chunk) grid whose chunk dimension runs in order
// with the (D, N) state stationary in VMEM.
//
// Bound.  u and dt are read and y written once: 12 bytes a (b, t, d) in
// fp32, 403 MB at falcon-mamba-7b's d_inner 8192 and L 4096, 0.120 ms at
// 3.35 TB/s.  N exponentials a (b, t, d) go through the SFU, 16 a clock
// an SM: 5.4e8 there, 0.128 ms on 132 SMs at 1.98 GHz.  The time loop is
// sequential, so the card's parallelism is batch x D x N state chains.
// Measured there on an H100 SXM (700 W): 0.25 ms, twice the bound.  Not
// the SFU (exponentials replaced by an FMA save 1%): the cross-lane sum of
// y, the ring's copies, the B and C loads and the y store each take 8-20%.
// The bf16-state instance is bound by instruction issue: a step of a
// state takes 18.4 instructions (the fp32 state's 8.8), 8 of them expf's
// (one MUFU.EX2), at 4 x 4096 x 8192, N 16 about 1.52 ms on that card
// (the fp32 state 0.87 ms), no spills.  Rounding each value by a scalar
// convert (F2F, 16 a clock an SM against 64 for the packed one: 7.75 a
// step of a state) took 5.05 ms there.  Its bound counts the roundings
// as operations beside the fp32 state's 7 N + 3.
//
// Design.  A thread owns one (b, d) channel and G = 4 of its states: a
// channel is S = 4 adjacent lanes, NP = 16 states (with N < 16 the states
// past N have A = B = C = 0, so they stay zero and add nothing).  At
// d_inner 8192 that is 32 k threads, 8 warps an SM, each with 4
// independent state chains whose only carried dependency is one FMA a
// step.  Its 4 entries of A sit in registers multiplied by log2(e), so
// exp(dt A) is one multiply and one ex2.approx.  A chunk's partial sums of
// y stay in registers until the chunk is done and are then summed across
// the channel's lanes by xor shuffles (reduce_scatter).  A block of CH =
// 32 channels streams the time axis in chunks of TCH steps through a
// STAGES-deep cp.async ring in shared memory: u and dt as the block's CH
// columns of TCH rows, B and C as TCH rows of NP (16-, 8- or 4-byte
// copies, or single bf16 elements, as the widths and the bases allow:
// gemm_tile.cuh's row_copy / copy_rows), so B_t and C_t reach a thread as
// one vector load.  y goes through a shared tile two chunks deep and is
// stored a chunk late as rows of the block's CH channels, 16, 8, 4 or 2
// bytes a store.  One barrier a chunk (two in the bf16-state instance
// with fp32 operands: round_chunk rounds the landed chunk's dt, u, B and
// C once for the block; the state and r(A) are bf16 pairs in registers).
// Copies past L and D are zero-filled: a dead step has dt = 0, so its
// decay is 1 and the state is unchanged, and a dead channel stays zero;
// neither is stored.  Nothing is branched on and nothing is padded in
// device memory.
#include <stdint.h>
#include <string.h>

#include "gemm_tile.cuh"

namespace {

using repro::gemm::copy_rows;
using repro::gemm::cp_async_commit;
using repro::gemm::cp_async_wait;
using repro::gemm::row_copy;
using repro::gemm::RowCopy;

constexpr int G = 4;        // states a thread
constexpr int S = 4;        // lanes a channel
constexpr int NP = G * S;   // states a channel, N <= NP
constexpr int CH = 32;      // channels a block
constexpr int THREADS = CH * S;  // a block
constexpr int TCH = 32;     // steps a chunk
constexpr int STAGES = 3;   // chunks in the ring
constexpr float kLog2e = 1.4426950408889634f;
// y tile row: CH + 8 elements, so that a warp's lanes (8 channels x 4
// state groups, each group writing its own step) hit distinct banks
constexpr int YS = CH + 8;

template <typename T>
struct Smem {
  T u[STAGES][TCH][CH];
  T dt[STAGES][TCH][CH];
  T b[STAGES][TCH][NP];
  T c[STAGES][TCH][NP];
  T y[2][TCH][YS];
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the G values at p (a shared-memory row, G-aligned) as floats
__device__ __forceinline__ void load_group(const float* p, float (&v)[G]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load_group(const __nv_bfloat16* p,
                                           float (&v)[G]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &q.x, sizeof(lo));
  memcpy(&hi, &q.y, sizeof(hi));
  const float2 fl = __bfloat1622float2(lo);
  const float2 fh = __bfloat1622float2(hi);
  v[0] = fl.x; v[1] = fl.y; v[2] = fh.x; v[3] = fh.y;
}

// Each of a channel's S lanes holds its partial y of the chunk's TCH steps
// in v[tt]; afterwards lane g holds the channel's y of steps g, g + S,
// g + 2 S, .. in v[0 ..].  Round M = 1, 2, .. S / 2 halves the steps a lane
// keeps: of each pair of neighbours it keeps the odd one if bit M of g is
// set, else the even one, sends the other to its partner (lane g ^ M) and
// adds what it receives.  So a step's S partials are summed in pairs (j,
// j ^ 1) first, then those sums in pairs j ^ 2.
template <int M, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[TCH], int g) {
  if constexpr (M < S) {
    const bool odd = g & M;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = odd ? v[2 * j] : v[2 * j + 1];
      const float keep = odd ? v[2 * j + 1] : v[2 * j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<2 * M, N / 2>(v, g);
  }
}

// `bytes` (16, 8, 4 or 2) shared -> global
__device__ __forceinline__ void store_chunk(void* dst, const void* src,
                                            int bytes) {
  if (bytes == 16) {
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  } else if (bytes == 8) {
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  } else if (bytes == 4) {
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  } else {
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
  }
}

// The bf16-state instance's primitives, on bf16 pairs in one 32-bit word
// (lo: the element at the lower address).  Each is held to its plain
// counterpart at every input (repro_scan_bf16_check below): pack2 to
// __float2bfloat16_rn, mul2 and add2 to __float2bfloat16_rn of
// __fmul_rn / __fadd_rn of the two values.  The .rn forms of mul and add
// are never contracted into an FMA.

// (lo, hi) rounded to bf16 (to nearest even; NaN stays NaN), one convert
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// a pair's elements as fp32 (exact)
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// a pair of the same bf16 (its bits in the low half of v), both halves
__device__ __forceinline__ uint32_t twice(uint32_t v) {
  return __byte_perm(v, 0, 0x1010);
}

// r(expf(x)) of both elements of a pair: expf, the plain version's fp32
// exponential (a range reduction around one ex2.approx), then one convert
__device__ __forceinline__ uint32_t exp_pair(uint32_t x) {
  return pack2(expf(lo_f(x)), expf(hi_f(x)));
}

// A landed chunk of fp32 operands, rounded once for the block (the
// bf16-state instance with fp32 operands): each (t, d) slot of dt becomes
// the pair (r(dt), r(r(dt) r(u))) (u stays, D u takes it unrounded), each
// group of G B's its G bf16 values in its first 8 bytes, each C r(C) in
// fp32.  Every slot is rewritten by the thread that reads it.
__device__ __forceinline__ void round_chunk(float (&u)[TCH][CH],
                                            float (&dt)[TCH][CH],
                                            float (&bm)[TCH][NP],
                                            float (&cm)[TCH][NP]) {
#pragma unroll
  for (int i = 0; i < TCH * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    float* slot = &dt[e / CH][e % CH];
    const uint32_t p = pack2(*slot, u[e / CH][e % CH]);  // (dr, ur)
    const uint32_t du = mul2(p, __byte_perm(p, 0, 0x1032));
    *reinterpret_cast<uint32_t*>(slot) = __byte_perm(p, du, 0x7610);
  }
  static_assert(TCH * NP / G == THREADS, "one B and one C group a thread");
  const int t = threadIdx.x / (NP / G);
  const int n = threadIdx.x % (NP / G) * G;
  const float4 b = *reinterpret_cast<const float4*>(&bm[t][n]);
  *reinterpret_cast<uint2*>(&bm[t][n]) =
      make_uint2(pack2(b.x, b.y), pack2(b.z, b.w));
  const float4 c = *reinterpret_cast<const float4*>(&cm[t][n]);
  const uint32_t c01 = pack2(c.x, c.y), c23 = pack2(c.z, c.w);
  *reinterpret_cast<float4*>(&cm[t][n]) =
      make_float4(lo_f(c01), hi_f(c01), lo_f(c23), hi_f(c23));
}

// Step tt of a chunk for the bf16-state instance: (dr, dr), (du, du), the
// thread's G B's as two pairs, its G r(C) in fp32 and u.  fp32 operands
// were rounded by round_chunk; bf16 operands are bf16 already, so only
// du = r(dr u) is formed here.
__device__ __forceinline__ void step_operands(
    const float* us, const float* ds, const float* bs, const float* cs,
    int tt, uint32_t& dr2, uint32_t& du2, uint2& bw, float (&cv)[G],
    float& uu) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(ds + tt * CH);
  dr2 = twice(w);
  du2 = __byte_perm(w, 0, 0x3232);
  bw = *reinterpret_cast<const uint2*>(bs + tt * NP);
  load_group(cs + tt * NP, cv);
  uu = us[tt * CH];
}

__device__ __forceinline__ void step_operands(
    const __nv_bfloat16* us, const __nv_bfloat16* ds,
    const __nv_bfloat16* bs, const __nv_bfloat16* cs, int tt,
    uint32_t& dr2, uint32_t& du2, uint2& bw, float (&cv)[G], float& uu) {
  const __nv_bfloat16 u = us[tt * CH];
  dr2 = twice(__bfloat16_as_ushort(ds[tt * CH]));
  du2 = mul2(dr2, twice(__bfloat16_as_ushort(u)));
  bw = *reinterpret_cast<const uint2*>(bs + tt * NP);
  load_group(cs + tt * NP, cv);
  uu = __bfloat162float(u);
}

// vec_ud, vec_bc, vec_y: elements a copy of u and dt, of B and C, and a
// store of y (each dividing its row width, D or N, with every row start
// aligned to it).  WIDE instances take every operand 16 bytes a copy, a
// width known at compile time: the copies and the y store of a chunk are
// straight-line code, with no division or branch on the width.
// BF16_STATE: the state in bf16, rounded as the header says.
template <typename T, bool WIDE, bool BF16_STATE>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ Dskip,
            T* __restrict__ y, float* __restrict__ state_out, int L, int D,
            int N, int vec_ud, int vec_bc, int vec_y) {
  __shared__ __align__(16) Smem<T> sm;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int width = min(CH, D - d0);  // live channels of the block
  const int c = threadIdx.x / S;      // channel in the block
  const int g = threadIdx.x % S;      // state group in the channel
  const int d = d0 + c;
  const bool live = c < width;

  // the fp32 state takes exp(dt A) as ex2(dt A log2(e)); the bf16 state
  // keeps r(A) and x as bf16 pairs (a2, x2) and takes expf
  float a[G], x[G];
  uint32_t a2[G / 2], x2[G / 2];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int n = g * G + j;
    const float an = live && n < N ? A[static_cast<size_t>(d) * N + n] : 0.f;
    if constexpr (BF16_STATE) {
      a[j] = an;
    } else {
      a[j] = an * kLog2e;
      x[j] = 0.f;
    }
  }
  if constexpr (BF16_STATE) {
#pragma unroll
    for (int h = 0; h < G / 2; ++h) {
      a2[h] = pack2(a[2 * h], a[2 * h + 1]);
      x2[h] = 0u;
    }
  }
  // D u joins the partial sum of the channel's first lane
  const float dskip = live && g == 0 ? Dskip[d] : 0.f;

  const size_t plane = static_cast<size_t>(L) * D;
  const T* ub = u + b * plane + d0;
  const T* dtb = dt + b * plane + d0;
  T* yb = y + b * plane + d0;
  const T* bb = Bm + static_cast<size_t>(b) * L * N;
  const T* cb = Cm + static_cast<size_t>(b) * L * N;
  // WIDE: the copy size, and the rows between a thread's copies of a u or
  // dt tile (CH columns) and of a B or C tile (NP columns)
  constexpr int VEC = 16 / sizeof(T);
  constexpr int W_BYTES = WIDE ? 16 : 0;
  constexpr int UD_STEP = WIDE ? THREADS / (CH / VEC) : 0;
  constexpr int BC_STEP = WIDE ? THREADS / (NP / VEC) : 0;
  if (WIDE) vec_ud = vec_bc = vec_y = VEC;
  const RowCopy ud_plan = row_copy<T, THREADS>(CH, width, vec_ud);
  const RowCopy bc_plan = row_copy<T, THREADS>(NP, N, vec_bc);
  const int chunks = (L + TCH - 1) / TCH;

  auto load = [&](int k) {
    const int s = k % STAGES;
    const int t0 = k * TCH;
    copy_rows<TCH, CH, W_BYTES, UD_STEP>(&sm.u[s][0][0], ub, t0, L, D,
                                         ud_plan);
    copy_rows<TCH, CH, W_BYTES, UD_STEP>(&sm.dt[s][0][0], dtb, t0, L, D,
                                         ud_plan);
    copy_rows<TCH, NP, W_BYTES, BC_STEP>(&sm.b[s][0][0], bb, t0, L, N,
                                         bc_plan);
    copy_rows<TCH, NP, W_BYTES, BC_STEP>(&sm.c[s][0][0], cb, t0, L, N,
                                         bc_plan);
  };
  // chunk k's y, from its tile to rows t0 .. t0 + TCH - 1
  auto store = [&](int k) {
    const T* ys = &sm.y[k & 1][0][0];
    const int t0 = k * TCH;
    const int per_row = CH / vec_y;
    const int bytes = vec_y * static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < (TCH * per_row + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / per_row;
      const int col = e % per_row * vec_y;
      if (e < TCH * per_row && t0 + r < L && col < width)
        store_chunk(yb + static_cast<size_t>(t0 + r) * D + col,
                    ys + r * YS + col, bytes);
    }
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < chunks) load(k);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 2>();
    // chunk k has landed for every thread; chunk k - 1's stage is no
    // longer read and its y tile is complete
    __syncthreads();
    if (k + STAGES - 1 < chunks) load(k + STAGES - 1);
    cp_async_commit();
    if (k > 0) store(k - 1);
    const int s = k % STAGES;
    if constexpr (BF16_STATE && sizeof(T) == 4) {
      round_chunk(sm.u[s], sm.dt[s], sm.b[s], sm.c[s]);
      __syncthreads();
    }
    const T* us = &sm.u[s][0][c];
    const T* ds = &sm.dt[s][0][c];
    const T* bs = &sm.b[s][0][g * G];
    const T* cs = &sm.c[s][0][g * G];
    // the chunk's steps, each lane's partial y in registers: nothing is
    // stored to shared memory here, so every step's loads can start early
    float acc[TCH];
#pragma unroll
    for (int tt = 0; tt < TCH; ++tt) {
      if constexpr (BF16_STATE) {
        uint32_t dr2, du2;
        uint2 bw;
        float cv[G], uu;
        step_operands(us, ds, bs, cs, tt, dr2, du2, bw, cv, uu);
        float p = dskip * uu;  // D u on the unrounded u
        const uint32_t bt[G / 2] = {mul2(du2, bw.x), mul2(du2, bw.y)};
#pragma unroll
        for (int h = 0; h < G / 2; ++h) {
          const uint32_t decay = exp_pair(mul2(dr2, a2[h]));
          x2[h] = add2(mul2(decay, x2[h]), bt[h]);
          p = fmaf(lo_f(x2[h]), cv[2 * h], p);
          p = fmaf(hi_f(x2[h]), cv[2 * h + 1], p);
        }
        acc[tt] = p;
      } else {
        const float dd = repro::to_float(ds[tt * CH]);
        const float uu = repro::to_float(us[tt * CH]);
        float bv[G], cv[G];
        load_group(bs + tt * NP, bv);
        load_group(cs + tt * NP, cv);
        float p = dskip * uu;
        const float du = dd * uu;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          x[j] = fmaf(ex2(dd * a[j]), x[j], du * bv[j]);
          p = fmaf(x[j], cv[j], p);
        }
        acc[tt] = p;
      }
    }
    reduce_scatter<1, TCH>(acc, g);
    T* ys = &sm.y[k & 1][g][c];
#pragma unroll
    for (int i = 0; i < TCH / S; ++i)
      ys[i * S * YS] = repro::from_float<T>(acc[i]);
  }
  __syncthreads();
  if (chunks > 0) store(chunks - 1);
  // the steps past L left the state as it was (dt = 0), so x is x_{L-1}
  if (state_out != nullptr && live) {
    float* so = state_out + (static_cast<size_t>(b) * D + d) * N;
    if constexpr (BF16_STATE) {
#pragma unroll
      for (int h = 0; h < G / 2; ++h) {
        x[2 * h] = lo_f(x2[h]);
        x[2 * h + 1] = hi_f(x2[h]);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (g * G + j < N) so[g * G + j] = x[j];
  }
}

template <typename T, bool BF16_STATE>
int launch(const void* u, const void* dt, const float* A, const void* B,
           const void* C, const float* Dskip, void* y, float* state_out,
           int batch, int L, int D, int N, int vec_ud, int vec_bc, int vec_y,
           cudaStream_t s) {
  const dim3 grid((D + CH - 1) / CH, batch);
  constexpr int wide = 16 / sizeof(T);
  auto kernel = vec_ud == wide && vec_bc == wide && vec_y == wide
                    ? scan_kernel<T, true, BF16_STATE>
                    : scan_kernel<T, false, BF16_STATE>;
  kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(B), static_cast<const T*>(C), Dskip,
      static_cast<T*>(y), state_out, L, D, N, vec_ud, vec_bc, vec_y);
  return repro::launch_status();
}

// vec elements of elem_bytes a copy: a width the copies have, dividing
// the row width, with the base aligned to it
bool copy_ok(const void* base, int vec, int width, int elem_bytes) {
  const bool listed = vec == 1 || vec == 2 || vec == 4 ||
                      (vec == 8 && elem_bytes == 2);
  return listed && width % vec == 0 &&
         reinterpret_cast<uintptr_t>(base) % (vec * elem_bytes) == 0;
}

// the widest copy of elem_bytes elements that copy_ok allows at base
int widest(const void* base, int width, int elem_bytes) {
  for (int vec = 16 / elem_bytes; vec > 1; vec /= 2)
    if (copy_ok(base, vec, width, elem_bytes)) return vec;
  return 1;
}

// The plain counterpart of a primitive: x as __nv_bfloat16, rounded with
// __float2bfloat16_rn
__device__ __forceinline__ uint32_t plain_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float plain_f(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ bool is_nan16(uint32_t h) {
  return (h & 0x7f80u) == 0x7f80u && (h & 0x7fu) != 0u;
}

// equal bits, or both NaN
__device__ __forceinline__ bool same16(uint32_t a, uint32_t b) {
  return a == b || (is_nan16(a) && is_nan16(b));
}

// Every input of one primitive against its plain counterpart: item i of
// 2^31 (2^15 for exp) is one packed call on two inputs, so both halves of
// the pair are exercised.  MUL, ADD: the bf16 pairs (a, b) = (i >> 15,
// 2 (i & 0x7fff)) in the low half, (i >> 15, 2 (i & 0x7fff) + 1) in the
// high half, every one of the 2^32; CVT: the fp32 bit patterns 2 i and
// 2 i + 1, every one of the 2^32; EXP: the bf16 values 2 i and 2 i + 1,
// every one of the 2^16.  out[0] += mismatches; out[1] = the least item
// that mismatched (unchanged if none).
enum { CHECK_MUL = 0, CHECK_ADD = 1, CHECK_CVT = 2, CHECK_EXP = 3 };

__global__ void check_kernel(int which, unsigned long long items,
                             unsigned long long* out) {
  unsigned int bad = 0;
  unsigned long long first = ~0ull;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += static_cast<unsigned long long>(gridDim.x) *
                        blockDim.x) {
    uint32_t got, want_lo, want_hi;
    if (which == CHECK_MUL || which == CHECK_ADD) {
      const uint32_t a = static_cast<uint32_t>(i >> 15);
      const uint32_t b = static_cast<uint32_t>(i & 0x7fff) * 2;
      const uint32_t a2 = a | a << 16, b2 = b | (b + 1) << 16;
      const float fa = plain_f(a);
      if (which == CHECK_MUL) {
        got = mul2(a2, b2);
        want_lo = plain_bits(__fmul_rn(fa, plain_f(b)));
        want_hi = plain_bits(__fmul_rn(fa, plain_f(b + 1)));
      } else {
        got = add2(a2, b2);
        want_lo = plain_bits(__fadd_rn(fa, plain_f(b)));
        want_hi = plain_bits(__fadd_rn(fa, plain_f(b + 1)));
      }
    } else if (which == CHECK_CVT) {
      const float lo = __uint_as_float(static_cast<uint32_t>(2 * i));
      const float hi = __uint_as_float(static_cast<uint32_t>(2 * i + 1));
      got = pack2(lo, hi);
      want_lo = plain_bits(lo);
      want_hi = plain_bits(hi);
    } else {
      const uint32_t x = static_cast<uint32_t>(2 * i);
      got = exp_pair(x | (x + 1) << 16);
      want_lo = plain_bits(expf(plain_f(x)));
      want_hi = plain_bits(expf(plain_f(x + 1)));
    }
    if (!same16(got & 0xffffu, want_lo) || !same16(got >> 16, want_hi)) {
      ++bad;
      first = min(first, i);
    }
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  for (int o = 16; o > 0; o /= 2)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
  if (threadIdx.x % 32 == 0 && bad) {
    atomicAdd(out, static_cast<unsigned long long>(bad));
    atomicMin(out + 1, first);
  }
}

}  // namespace

// which: 0 mul, 1 add, 2 cvt, 3 exp (check_kernel); out: two uint64, the
// mismatches added to out[0], the least mismatching item min'ed into
// out[1]
extern "C" int repro_scan_bf16_check(int which, void* out, void* stream) {
  if (which < CHECK_MUL || which > CHECK_EXP)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned long long items = which == CHECK_EXP ? 1ull << 15
                                                      : 1ull << 31;
  const int blocks = which == CHECK_EXP ? 128 : 4096;
  check_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      which, items, static_cast<unsigned long long*>(out));
  return repro::launch_status();
}

// vec_ud, vec_bc: elements a copy of u and dt, and of B and C
// (kernels/mamba_scan.py::scan_copies); y's store takes the widest width
// its base and D allow.  state_out: null, or (batch, D, N) fp32 for the
// final state.  bf16_state: keep the state in bf16 (the header's
// rounding points)
extern "C" int repro_mamba_scan(const void* u, const void* dt, const float* A,
                                const void* B, const void* C,
                                const float* Dskip, void* y,
                                float* state_out, int is_bf16, int bf16_state,
                                int batch, int L, int D, int N, int vec_ud,
                                int vec_bc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = is_bf16 ? 2 : 4;
  if (N < 1 || N > NP || !copy_ok(u, vec_ud, D, es) ||
      !copy_ok(dt, vec_ud, D, es) || !copy_ok(B, vec_bc, N, es) ||
      !copy_ok(C, vec_bc, N, es))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_y = widest(y, D, es);
  auto run = is_bf16 ? (bf16_state ? launch<__nv_bfloat16, true>
                                   : launch<__nv_bfloat16, false>)
                     : (bf16_state ? launch<float, true>
                                   : launch<float, false>);
  return run(u, dt, A, B, C, Dskip, y, state_out, batch, L, D, N, vec_ud,
             vec_bc, vec_y, s);
}
