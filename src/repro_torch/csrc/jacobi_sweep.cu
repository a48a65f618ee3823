// Jacobi pivot rounds over a batch in one launch: (C, V) (B, n, n) fp32 and
// R rounds of k disjoint (p, q) pairs -> (C'', V'') after all R rounds (a
// whole sweep is one call).
//
// Replaces the TPU kernel repro/kernels/fused.py::jacobi_sweep_step (body
// _sweep_kernel): gather apq/app/aqq for each pair -> angle (rutishauser |
// atan2 | Q2.29 CORDIC) -> null-pivot guard -> rotate the rows, then the
// columns of C, and the columns of V.  On the TPU the whole (n, n) C and V
// sit in VMEM for one round and lax.scan drives the rounds inside one
// compiled program.  Here one launch runs every round, and C and V stay on
// chip between rounds, in one of two residencies that the wrapper
// (kernels/fused.py::sweep_plan) chooses before the launch:
//
//   sweep_smem_kernel  one block per problem with C and V in shared memory
//     (2 n (n|1) floats: n <= 128 on the H100, 129 KiB).  Each round, in
//     place, with block barriers only: (1) the k angles and null-pivot
//     guards, (2) the rows of each pair, (3) the columns of each pair in C
//     and V -- the reference's order (core/jacobi.py), so every value is
//     the plain version's.  C and V are read once and written once.
//
//   sweep_grid_kernel  every larger n (784 on the main path): a persistent
//     cooperative grid over the tiles of every problem, with C and V
//     (4.9 MB at n = 784) in the 50 MB L2.  The block of C at (pair i) x
//     (pair j) after a round depends only on the same 2 x 2 block before
//     it, and V's (rows of pair i) x (columns of pair j) likewise, so a
//     thread owns one 2 x 2 block of each and C and V cross L2 once a
//     round; round r reads one (C, V) pair and writes the other
//     (ping-pong), so one grid barrier a round is enough.  A tile is
//     16 x 32 such blocks; each block of threads reads the round's pairs
//     into shared memory and computes its tile's 48 angles from the
//     round's input: no angle phase, no second barrier.
//
// Buffers written earlier in the same launch are read with ld.global.cg
// (__ldcg, through L2): never through the read-only path (no __ldg, no
// const __restrict__ on the ping-pong pointers) nor L1, which is not
// coherent across SMs.  The grid barrier is written by hand (an arrival
// word whose top bit flips once every block has arrived, a release before
// arriving and acquire loads while waiting), so the build needs no
// relocatable device code; the launch is cooperative, so a grid that
// cannot be resident at once is refused instead of deadlocking.
//
// Products and sums use __fmul_rn / __fadd_rn / __fsub_rn so nvcc cannot
// contract c*x - s*y into an FMA: the rotation is the same float arithmetic
// as the plain PyTorch version, and a null pivot (c = 1, s = 0) leaves
// padded coordinates exactly zero.  IEEE sqrt and division: never build
// with fast math.
//
// Bound of one sweep (R = n - 1 rounds): C and V read once and written
// once, 16 n^2 bytes (9.8 MB at n = 784, 3 us at 3.35 TB/s); 9 n^2 (n - 1)
// flops (4.3 GFLOP, 64 us at 67 TFLOP/s fp32): bound by operations.  The
// grid kernel is far from it, latency-bound: on the H100 a round at
// n = 784 takes about 6 us, the grid barrier, the loads' round trip with
// the angles, and the stores' drain about 2 us each
// (scripts/kernel_ab.py jacobi, with variants that skip each part).
#include <stdint.h>

#include "common.cuh"
#include "cordic.cuh"

namespace {

constexpr int MODE_RUTISHAUSER = 0;
constexpr int MODE_ATAN2 = 1;
constexpr int MODE_CORDIC = 2;

// rotation seed round(f32(1/K) * 2^29), as repro_torch/core/cordic.py
constexpr int32_t kX0Fixed = 326016448;
constexpr float kHalfPi = 1.57079637050628662f;    // float32(pi / 2)

__device__ void cordic_sincos(float theta, float* sin_out, float* cos_out) {
  const bool fold_hi = theta > kHalfPi;
  const bool fold_lo = theta < -kHalfPi;
  const float th = fold_hi ? __fsub_rn(theta, kPi)
                           : (fold_lo ? __fadd_rn(theta, kPi) : theta);
  int32_t zi = to_fixed(th);
  int32_t xi = kX0Fixed;
  int32_t yi = 0;
#pragma unroll
  for (int i = 0; i < CORDIC_ITERS; ++i) {
    const int32_t d = zi >= 0 ? 1 : -1;
    const int32_t xs = xi >> i;
    const int32_t ys = yi >> i;
    xi = xi - d * ys;
    yi = yi + d * xs;
    zi = zi - d * kAtanFixed[i];
  }
  const float sign = (fold_hi || fold_lo) ? -1.f : 1.f;
  *sin_out = __fmul_rn(from_fixed(yi), sign);
  *cos_out = __fmul_rn(from_fixed(xi), sign);
}

__device__ void rotation(float apq, float app, float aqq, int mode, float* c,
                         float* s) {
  if (mode == MODE_RUTISHAUSER) {
    const bool safe = fabsf(apq) > 0.f;
    const float den = safe ? __fmul_rn(2.f, apq) : 1.f;
    const float tau = __fdiv_rn(__fsub_rn(app, aqq), den);
    const float sgn = tau >= 0.f ? 1.f : -1.f;
    float t = __fdiv_rn(
        sgn, __fadd_rn(fabsf(tau),
                       __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)))));
    t = safe ? -t : 0.f;
    // c rounded once from double, as core/cordic.py does (two float
    // roundings bias c^2 + s^2 above 1 and the eigenvalues drift)
    const double u = static_cast<double>(__fadd_rn(1.f, __fmul_rn(t, t)));
    *c = __double2float_rn(__ddiv_rn(1.0, __dsqrt_rn(u)));
    *s = __fmul_rn(t, *c);
  } else if (mode == MODE_ATAN2) {
    const float theta =
        __fmul_rn(-0.5f, atan2f(__fmul_rn(2.f, apq), __fsub_rn(app, aqq)));
    *c = cosf(theta);
    *s = sinf(theta);
  } else {
    const float full = cordic_atan2(__fmul_rn(2.f, apq), __fsub_rn(app, aqq));
    cordic_sincos(__fmul_rn(-0.5f, full), s, c);
  }
}

// (c, s) of the in-range pair (p, q) from its three entries, with the
// null-pivot guard: apq == 0 or p == q is the exact identity
__device__ __forceinline__ void guarded_rotation(float apq, float app,
                                                 float aqq, int p, int q,
                                                 int mode, float* c,
                                                 float* s) {
  rotation(apq, app, aqq, mode, c, s);
  if (apq == 0.f || p == q) {
    *c = 1.f;
    *s = 0.f;
  }
}

// The pairs come from the host's pivot schedule; one out of [0, n) would
// read and write outside C, so it is no rotation at all.
__device__ __forceinline__ bool in_range(int p, int q, int n) {
  return p >= 0 && p < n && q >= 0 && q < n;
}

// role 0: the p side, c*x_p - s*x_q; role 1: the q side, s*x_p + c*x_q
__device__ __forceinline__ float combine(int role, float c, float s, float xp,
                                         float xq) {
  return role == 0 ? __fsub_rn(__fmul_rn(c, xp), __fmul_rn(s, xq))
                   : __fadd_rn(__fmul_rn(s, xp), __fmul_rn(c, xq));
}

// -- shared-memory residency: one block per problem --------------------------

constexpr int SMEM_MAX_THREADS = 512;

// odd row pitch: a walk down a column touches 32 different banks
__host__ __device__ __forceinline__ int smem_pitch(int n) { return n | 1; }

size_t smem_bytes(int n, int k) {
  // C and V, (c, s) and (p, q) of each pair; kernels/fused.py mirrors it
  return sizeof(float) * (2 * static_cast<size_t>(n) * smem_pitch(n) +
                          4 * static_cast<size_t>(k));
}

__global__ void __launch_bounds__(SMEM_MAX_THREADS)
sweep_smem_kernel(const float* __restrict__ C, const float* __restrict__ V,
                  const int32_t* __restrict__ pairs, float* __restrict__ Co,
                  float* __restrict__ Vo, int n, int k, int rounds,
                  int mode) {
  extern __shared__ float smem[];
  const int ld = smem_pitch(n);
  float* c = smem;                // n x ld
  float* v = c + n * ld;          // n x ld
  float* cs = v + n * ld;         // k x (c, s)
  int* pq = reinterpret_cast<int*>(cs + 2 * k);  // k x (p, q); p < 0: none
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int warp = threadIdx.y;
  const int warps = blockDim.y;
  const int lane = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;

  for (int i = tid; i < n * n; i += nt) {
    const int r = i / n;
    const int col = i - r * n;
    c[r * ld + col] = C[off + i];
    v[r * ld + col] = V[off + i];
  }
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    const int32_t* pr = pairs + static_cast<size_t>(round) * k * 2;
    for (int j = tid; j < k; j += nt) {
      int p = pr[2 * j];
      const int q = pr[2 * j + 1];
      float cc = 1.f, ss = 0.f;
      if (in_range(p, q, n)) {
        guarded_rotation(c[p * ld + q], c[p * ld + p], c[q * ld + q], p, q,
                         mode, &cc, &ss);
      } else {
        p = -1;
      }
      pq[2 * j] = p;
      pq[2 * j + 1] = q;
      cs[2 * j] = cc;
      cs[2 * j + 1] = ss;
    }
    __syncthreads();
    // rows: a warp per pair, lanes along the columns
    for (int j = warp; j < k; j += warps) {
      const int p = pq[2 * j];
      if (p < 0) continue;
      const int q = pq[2 * j + 1];
      const float cc = cs[2 * j], ss = cs[2 * j + 1];
      for (int col = lane; col < n; col += 32) {
        const float x = c[p * ld + col];
        const float y = c[q * ld + col];
        c[p * ld + col] = combine(0, cc, ss, x, y);
        c[q * ld + col] = combine(1, cc, ss, x, y);  // p == q: this wins
      }
    }
    __syncthreads();
    // columns of the row-rotated C, and of V: a warp per pair, lanes down
    // the rows
    for (int j = warp; j < k; j += warps) {
      const int p = pq[2 * j];
      if (p < 0) continue;
      const int q = pq[2 * j + 1];
      const float cc = cs[2 * j], ss = cs[2 * j + 1];
      for (int r = lane; r < n; r += 32) {
        const float x = c[r * ld + p];
        const float y = c[r * ld + q];
        c[r * ld + p] = combine(0, cc, ss, x, y);
        c[r * ld + q] = combine(1, cc, ss, x, y);
        const float a = v[r * ld + p];
        const float b = v[r * ld + q];
        v[r * ld + p] = combine(0, cc, ss, a, b);
        v[r * ld + q] = combine(1, cc, ss, a, b);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < n * n; i += nt) {
    const int r = i / n;
    const int col = i - r * n;
    Co[off + i] = c[r * ld + col];
    Vo[off + i] = v[r * ld + col];
  }
}

// -- L2 residency: a persistent cooperative grid -----------------------------
//
// A round's pairs and the coordinates in no pair partition [0, n) into
// units of two coordinates (a pair) or one.  The output block (rows of unit
// i) x (columns of unit j) of C depends only on the same block of the
// round's input, and V's rows of unit i x columns of unit j on the same
// block of V: so a thread owns one such 2 x 2 block of C and of V, reads
// exactly what it writes, and C and V cross L2 once a round.  Units
// 0 .. k-1 are the pairs (one out of range is no unit); where the live
// pairs leave coordinates uncovered (the cyclic pivot's k = 1), units
// k .. k+n-1 are the coordinates, those in a pair being no unit.

constexpr int UX = 32;        // unit columns of a tile: threadIdx.x
constexpr int UY = 8;         // threadIdx.y
constexpr int UR = 2 * UY;    // unit rows of a tile: y and y + UY
constexpr int PREFETCH = 4;   // pair entries a thread loads a round ahead

size_t grid_smem_bytes(int n, int k) {
  // the round's pairs, and which coordinates they cover
  return sizeof(int) * (2 * static_cast<size_t>(k) + static_cast<size_t>(n));
}

// The coordinates (a, b) of unit u: b < 0 for a single coordinate, a < 0
// for no unit; a == b for a degenerate pair (p == q).
__device__ __forceinline__ void unit_of(int u, int units, int k, int n,
                                        const int* pq, const int* covered,
                                        int* a, int* b) {
  *a = -1;
  *b = -1;
  if (u >= units) return;
  if (u < k) {
    const int p = pq[2 * u];
    const int q = pq[2 * u + 1];
    if (in_range(p, q, n)) {
      *a = p;
      *b = q;
    }
  } else if (!covered[u - k]) {
    *a = u - k;
  }
}

// Every block of the grid waits here until all have arrived.  Block 0 adds
// 2^31 - (blocks - 1) and every other block 1, so the word's top bit flips
// exactly when the last one arrives (the word starts at 0 and gains 2^31 a
// barrier).  The block's writes are ordered before its arrival by the
// block barrier and a gpu-scope release fence; the reads after the wait by
// gpu-scope acquire loads of the word (5% faster a sweep than
// __threadfence on both sides, scripts/kernel_ab.py jacobi).
__device__ __forceinline__ void grid_barrier(unsigned int* word) {
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned int old, now;
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "atom.relaxed.gpu.global.add.u32 %0, [%1], %2;\n"
        : "=r"(old)
        : "l"(word), "r"(add)
        : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(now)
                   : "l"(word)
                   : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(UX* UY)
sweep_grid_kernel(const float* C, const float* V,
                  const int32_t* __restrict__ pairs, float* Co, float* Vo,
                  float* Cs, float* Vs, unsigned int* barrier, int batch,
                  int n, int k, int rounds, int mode) {
  extern __shared__ int table[];
  int* pq = table;              // the round's pairs
  int* covered = table + 2 * k;  // coordinate -> in a live pair
  __shared__ int covered_count;
  __shared__ float ang[2][UR + UX];  // (c, s) of the tile's row units, then
                                     // its column units
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * UX + x;
  const int nt = UX * UY;
  const size_t nn = static_cast<size_t>(n) * n;
  // the next round's first PREFETCH * nt pair entries, loaded while this
  // round computes (the pairs are never written)
  int ahead[PREFETCH];
  auto load_ahead = [&](int round) {
    const int32_t* pr = pairs + static_cast<size_t>(round) * k * 2;
#pragma unroll
    for (int e = 0; e < PREFETCH; ++e) {
      const int i = tid + e * nt;
      ahead[e] = i < 2 * k ? __ldg(pr + i) : 0;
    }
  };
  load_ahead(0);

  for (int round = 0; round < rounds; ++round) {
    // round r writes buffer (R - 1 - r) % 2 of (out, spare), so the last
    // round writes out; it reads what round r - 1 wrote, or the input
    const bool to_spare = ((rounds - 1 - round) & 1) != 0;
    const float* Ci = round == 0 ? C : (to_spare ? Co : Cs);
    const float* Vi = round == 0 ? V : (to_spare ? Vo : Vs);
    float* Cd = to_spare ? Cs : Co;
    float* Vd = to_spare ? Vs : Vo;

    const int32_t* pr = pairs + static_cast<size_t>(round) * k * 2;
#pragma unroll
    for (int e = 0; e < PREFETCH; ++e) {
      const int i = tid + e * nt;
      if (i < 2 * k) pq[i] = ahead[e];
    }
    for (int i = tid + PREFETCH * nt; i < 2 * k; i += nt) pq[i] = __ldg(pr + i);
    for (int i = tid; i < n; i += nt) covered[i] = 0;
    if (tid == 0) covered_count = 0;
    __syncthreads();
    if (round + 1 < rounds) load_ahead(round + 1);
    int mine = 0;
    for (int j = tid; j < k; j += nt) {
      const int p = pq[2 * j];
      const int q = pq[2 * j + 1];
      if (in_range(p, q, n)) {
        covered[p] = 1;
        covered[q] = 1;
        mine += p == q ? 1 : 2;
      }
    }
    if (mine) atomicAdd(&covered_count, mine);
    __syncthreads();
    const int units = covered_count == n ? k : k + n;
    const int urows = (units + UR - 1) / UR;
    const int ucols = (units + UX - 1) / UX;
    const int per_problem = urows * ucols;
    const int total = batch * per_problem;

    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int b = t / per_problem;
      const int tt = t - b * per_problem;
      const int ur0 = (tt / ucols) * UR;
      const int uc0 = (tt % ucols) * UX;
      const float* Cb = Ci + b * nn;
      const float* Vb = Vi + b * nn;

      // this thread's column unit and two row units, and their blocks of C
      // and V, loaded before the angles are known
      int aj, bj, ai[2], bi[2];
      unit_of(uc0 + x, units, k, n, pq, covered, &aj, &bj);
      float xc[2][4] = {}, xv[2][4] = {};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unit_of(ur0 + y + UY * h, units, k, n, pq, covered, &ai[h], &bi[h]);
        if (ai[h] < 0 || aj < 0) continue;
        const size_t ra = static_cast<size_t>(ai[h]) * n;
        const size_t rb = static_cast<size_t>(bi[h]) * n;
        xc[h][0] = __ldcg(Cb + ra + aj);
        xv[h][0] = __ldcg(Vb + ra + aj);
        if (bj >= 0) {
          xc[h][1] = __ldcg(Cb + ra + bj);
          xv[h][1] = __ldcg(Vb + ra + bj);
        }
        if (bi[h] >= 0) {
          xc[h][2] = __ldcg(Cb + rb + aj);
          xv[h][2] = __ldcg(Vb + rb + aj);
          if (bj >= 0) {
            xc[h][3] = __ldcg(Cb + rb + bj);
            xv[h][3] = __ldcg(Vb + rb + bj);
          }
        }
      }
      if (tid < UR + UX) {  // the angle of each of the tile's units
        int a, q;
        unit_of(tid < UR ? ur0 + tid : uc0 + tid - UR, units, k, n, pq,
                covered, &a, &q);
        float cc = 1.f, ss = 0.f;
        if (q >= 0) {
          guarded_rotation(__ldcg(Cb + static_cast<size_t>(a) * n + q),
                           __ldcg(Cb + static_cast<size_t>(a) * n + a),
                           __ldcg(Cb + static_cast<size_t>(q) * n + q), a, q,
                           mode, &cc, &ss);
        }
        ang[0][tid] = cc;
        ang[1][tid] = ss;
      }
      __syncthreads();

      const float cj = ang[0][UR + x], sj = ang[1][UR + x];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ai[h] < 0 || aj < 0) continue;
        const float ci = ang[0][y + UY * h], si = ang[1][y + UY * h];
        // rows first: r[0..1] row ai, r[2..3] row bi (a degenerate pair's
        // row is its q side, as the plain version's second scatter)
        float r[4] = {xc[h][0], xc[h][1], 0.f, 0.f};
        if (bi[h] >= 0) {
          r[0] = combine(0, ci, si, xc[h][0], xc[h][2]);
          r[2] = combine(1, ci, si, xc[h][0], xc[h][2]);
          if (bj >= 0) {
            r[1] = combine(0, ci, si, xc[h][1], xc[h][3]);
            r[3] = combine(1, ci, si, xc[h][1], xc[h][3]);
          }
          if (bi[h] == ai[h]) {
            r[0] = r[2];
            r[1] = r[3];
          }
        }
        // then the columns, of C and of V, stored in the plain version's
        // order (a degenerate pair's q side written last)
        const size_t ra = b * nn + static_cast<size_t>(ai[h]) * n;
        const size_t rb = b * nn + static_cast<size_t>(bi[h]) * n;
        if (bj >= 0) {
          Cd[ra + aj] = combine(0, cj, sj, r[0], r[1]);
          Cd[ra + bj] = combine(1, cj, sj, r[0], r[1]);
          Vd[ra + aj] = combine(0, cj, sj, xv[h][0], xv[h][1]);
          Vd[ra + bj] = combine(1, cj, sj, xv[h][0], xv[h][1]);
          if (bi[h] >= 0) {
            Cd[rb + aj] = combine(0, cj, sj, r[2], r[3]);
            Cd[rb + bj] = combine(1, cj, sj, r[2], r[3]);
            Vd[rb + aj] = combine(0, cj, sj, xv[h][2], xv[h][3]);
            Vd[rb + bj] = combine(1, cj, sj, xv[h][2], xv[h][3]);
          }
        } else {
          Cd[ra + aj] = r[0];
          Vd[ra + aj] = xv[h][0];
          if (bi[h] >= 0) {
            Cd[rb + aj] = r[2];
            Vd[rb + aj] = xv[h][2];
          }
        }
      }
      __syncthreads();  // ang is the next tile's
    }
    if (round + 1 < rounds) grid_barrier(barrier);
  }
}

}  // namespace

// Limits the wrapper plans with: the opt-in shared memory of one block,
// the SM count, and how many blocks of the grid kernel an SM holds at this
// (n, k); cooperative launch must be supported.
extern "C" int repro_jacobi_sweep_limits(int n, int k, int* smem_optin,
                                         int* sms, int* grid_blocks_per_sm) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  const size_t bytes = grid_smem_bytes(n, k);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = static_cast<cudaError_t>(repro::allow_smem(sweep_grid_kernel, bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        grid_blocks_per_sm, sweep_grid_kernel, UX * UY, bytes);
  return static_cast<int>(err);
}

// R = rounds rounds of the (R, k, 2) int32 pairs over (C, V) -> (Co, Vo);
// mode: 0 rutishauser, 1 atan2, 2 cordic.  smem != 0: the shared-memory
// kernel, one block per problem (grid ignored).  smem == 0: the grid
// kernel with `grid` blocks, all resident at once, ping-ponging between
// (Co, Vo) and the spare (Cs, Vs) (unused when R == 1), with `barrier` one
// zeroed word.  Co/Vo/Cs/Vs must not alias C/V or each other.
extern "C" int repro_jacobi_sweep(const float* C, const float* V,
                                  const int32_t* pairs, float* Co, float* Vo,
                                  float* Cs, float* Vs, unsigned int* barrier,
                                  int batch, int n, int k, int rounds,
                                  int mode, int smem, int grid,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem) {
    const size_t bytes = smem_bytes(n, k);
    int status = repro::allow_smem(sweep_smem_kernel, bytes);
    if (status) return status;
    // warps: about 8 (row, pair) items a thread per phase, 2 to 16
    const int want = (k * n / 8 + 31) / 32;
    const int warps = want < 2 ? 2 : (want > SMEM_MAX_THREADS / 32
                                          ? SMEM_MAX_THREADS / 32
                                          : want);
    sweep_smem_kernel<<<batch, dim3(32, warps), bytes, s>>>(
        C, V, pairs, Co, Vo, n, k, rounds, mode);
    return repro::launch_status();
  }
  const size_t bytes = grid_smem_bytes(n, k);
  if (bytes > 48 * 1024) {
    int status = repro::allow_smem(sweep_grid_kernel, bytes);
    if (status) return status;
  }
  void* args[] = {&C,  &V,       &pairs, &Co, &Vo, &Cs,     &Vs,
                  &barrier, &batch, &n,  &k,  &rounds, &mode};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sweep_grid_kernel), dim3(grid),
      dim3(UX, UY), args, bytes, s);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(err);
  }
  return repro::launch_status();
}
