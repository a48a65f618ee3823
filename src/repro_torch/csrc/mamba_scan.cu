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
// each product and sum of two bf16 values in fp32 (__fmul_rn, __fadd_rn:
// nothing contracted into an FMA across a rounding point), exp as expf
// (the fp32 exp of the plain version, not ex2.approx), y summed in fp32
// and D u on the unrounded u.  The final state is stored in fp32 (bf16
// values).
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
// The bf16-state instance adds 3 roundings a (b, t, d) (dt, u, dt u) and
// 7 a (b, t, d, n) (B, C, dt A, a_t, b_t, a_t x, x_t), each a convert to
// bf16 and a shift back, and takes expf (a range reduction around one
// ex2.approx) for the ex2 of the fp32 state: at 4 x 4096 x 8192, N 16,
// 2.15e9 (b, t, d, n), 1.5e10 roundings more.  Its bound counts the
// roundings as operations beside the fp32 state's 7 N + 3.  It is not
// tuned: a simple instance that rounds where the reference rounds.
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
// bytes a store.  One barrier a chunk.  Copies past L and D are
// zero-filled: a dead step has dt = 0, so its decay is 1 and the state is
// unchanged, and a dead channel stays zero; neither is stored.  Nothing is
// branched on and nothing is padded in device memory.
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

// bf16 round to nearest even, back in fp32
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

  float a[G], x[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int n = g * G + j;
    const float an = live && n < N ? A[static_cast<size_t>(d) * N + n] : 0.f;
    // the fp32 state takes exp(dt A) as ex2(dt A log2(e)); the bf16 state
    // rounds A to bf16 and takes expf
    a[j] = BF16_STATE ? bf16r(an) : an * kLog2e;
    x[j] = 0.f;
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
    const T* us = &sm.u[s][0][c];
    const T* ds = &sm.dt[s][0][c];
    const T* bs = &sm.b[s][0][g * G];
    const T* cs = &sm.c[s][0][g * G];
    // the chunk's steps, each lane's partial y in registers: nothing is
    // stored to shared memory here, so every step's loads can start early
    float acc[TCH];
#pragma unroll
    for (int tt = 0; tt < TCH; ++tt) {
      const float dd = repro::to_float(ds[tt * CH]);
      const float uu = repro::to_float(us[tt * CH]);
      float bv[G], cv[G];
      load_group(bs + tt * NP, bv);
      load_group(cs + tt * NP, cv);
      float p = dskip * uu;  // D u on the unrounded u in either state
      if constexpr (BF16_STATE) {
        const float dr = bf16r(dd);
        const float du = bf16r(__fmul_rn(dr, bf16r(uu)));
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float decay = bf16r(expf(bf16r(__fmul_rn(dr, a[j]))));
          const float bt = bf16r(__fmul_rn(du, bf16r(bv[j])));
          x[j] = bf16r(__fadd_rn(bf16r(__fmul_rn(decay, x[j])), bt));
          p = fmaf(x[j], bf16r(cv[j]), p);
        }
      } else {
        const float du = dd * uu;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          x[j] = fmaf(ex2(dd * a[j]), x[j], du * bv[j]);
          p = fmaf(x[j], cv[j], p);
        }
      }
      acc[tt] = p;
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

}  // namespace

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
