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
//     thread owns one 2 x 2 block of each.  A tile is 16 x 32 such
//     blocks; each block of threads reads the round's pairs into shared
//     memory and computes its tile's 48 angles from the round's input: no
//     angle phase.  A step reads one (C, V) pair and writes the other
//     (ping-pong), and the steps are separated by grid barriers.
//
//     Two rounds a step (the <2> instance, which the wrapper takes where
//     the pairs can cover every coordinate and every tile is resident at
//     once): under the circle method (core/jacobi.py::round_robin_rounds)
//     every player but seat 0 moves one seat a round, so a coordinate's
//     unit (the index of its pair) moves by at most one from round r to
//     round r + 1.  A tile's rows and columns at round r + 1 then read
//     round r's output only on the tile widened by one unit a side (18 x
//     34 blocks of C, V's rows of the tile over 34 column units), and its
//     angles only the three near-diagonal entries of each unit.  Each
//     block loads those from the step's input in one trip, computes round
//     r on them with the same rotation() and combine() calls on the same
//     operands (a halo block is computed by two blocks, bitwise alike),
//     keeps the entries round r + 1 reads in shared memory, and stores
//     round r + 1 alone: one barrier, one load trip and one store drain
//     for two rounds, 391 barriers a sweep at n = 784 instead of 782.
//     Which steps are of that kind (both rounds cover every coordinate,
//     none moves by more than one unit) is checked once a launch, before
//     the first step, each block a share, into flags beside the barrier's
//     word: a step then reads no pair table, only its tile's pairs, loaded
//     a step ahead.  A step of any other table runs its two rounds one
//     barrier apart through a third buffer, so every table stays bitwise;
//     an odd R ends on a single round.
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
// grid kernel is far from it, latency-bound.  On the H100 a round at
// n = 784 took 6.1 us at one round a barrier: the grid barrier with the
// round's table 2.09, the loads' round trip with the angles 2.01, the
// stores' drain 2.03 us (scripts/kernel_ab.py jacobi, with variants that
// skip each part).  A two-round step took 10.7 us, 5.35 a round: the
// grid barrier 2.6 us (0.75 ms a sweep without the tiles: the barrier,
// the flags and the next pairs), the stores' drain 2.0, the loads, both
// rounds' angles and the staging the other 6.1 (against 4.0 for two
// rounds of loads and angles).  That part is the larger because a
// thread's staged blocks are stored to shared memory as their loads
// return, about six L2 round trips one after another; holding the loads
// in registers instead spills at the 80 registers that three blocks an
// SM allow (4.7 ms a sweep).  Where each block takes two or three tiles a
// step (a 32 x 256 flush) that work is paid per tile, and two rounds a
// barrier took 3.95 ms a sweep against 3.14-3.20 at one, so the wrapper
// plans them only where every tile is resident at once.
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
constexpr int NT = UX * UY;   // threads of a block
constexpr int HX = UX + 2;    // a tile's column units widened by one a side
constexpr int HR = UR + 2;    // its row units, likewise
constexpr int PREFETCH = 4;   // pair entries a thread loads a round ahead
constexpr int AT = HR + HX;   // a widened tile's units: rows, then columns
constexpr int UT = AT + UR + UX;  // and the tile's own units after them

// The staging of a two-round step (floats): C after the first round over
// the widened tile's coordinates, V's rows of the tile over the widened
// columns, the three entries each of the tile's units reads for its
// second-round angle, the first round's (c, s) over the widened tile, and
// (ints) where each of the tile's row and column coordinates lies in the
// first two, and the coordinates of the widened tile's units in round r
// and of the tile's units in round r + 1.
constexpr int STAGE_FLOATS = (2 * HR) * (2 * HX) + (2 * UR) * (2 * HX) +
                             3 * (UR + UX) + 2 * AT + 2 * (UR + UX) +
                             2 * UT;

size_t grid_smem_bytes(int n, int k, int depth) {
  // each round's pairs and which coordinates the first covers, and at
  // depth 2 the staging
  return sizeof(int) * (static_cast<size_t>(depth) * 2 * k + n +
                        (depth > 1 ? STAGE_FLOATS : 0));
}

// One round's pairs and coverage in shared memory.
struct Table {
  const int* pq;       // the round's k pairs
  const int* covered;  // coordinate -> in a live pair
  int units;           // k, or k + n where some coordinate is in no pair
};

// The coordinates (a, b) of unit u: b < 0 for a single coordinate, a < 0
// for no unit; a == b for a degenerate pair (p == q).
__device__ __forceinline__ void unit_of(int u, const Table& t, int k, int n,
                                        int* a, int* b) {
  *a = -1;
  *b = -1;
  if (u >= t.units) return;
  if (u < k) {
    const int p = t.pq[2 * u];
    const int q = t.pq[2 * u + 1];
    if (in_range(p, q, n)) {
      *a = p;
      *b = q;
    }
  } else if (!t.covered[u - k]) {
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

// The 2 x 2 block of rows (ra, rb) x columns (ca, cb) of M (rb < 0 or
// cb < 0: that side is one coordinate), through L2: M may have been
// written earlier in the launch.
__device__ __forceinline__ void load_block(const float* M, int n, int ra,
                                           int rb, int ca, int cb,
                                           float x[4]) {
  const size_t a = static_cast<size_t>(ra) * n;
  x[0] = __ldcg(M + a + ca);
  if (cb >= 0) x[1] = __ldcg(M + a + cb);
  if (rb >= 0) {
    const size_t b = static_cast<size_t>(rb) * n;
    x[2] = __ldcg(M + b + ca);
    if (cb >= 0) x[3] = __ldcg(M + b + cb);
  }
}

// The columns (aj, bj) of a 2 x 2 block r rotated by (cj, sj): what the
// stores of rotate_store leave at (row a|b, column aj|bj), o[0..1] row a,
// o[2..3] row b (a degenerate pair's q side, written last).
__device__ __forceinline__ void rotate_cols(const float r[4], int aj, int bj,
                                            float cj, float sj, float o[4]) {
  if (bj >= 0) {
    o[0] = combine(0, cj, sj, r[0], r[1]);
    o[1] = combine(1, cj, sj, r[0], r[1]);
    o[2] = combine(0, cj, sj, r[2], r[3]);
    o[3] = combine(1, cj, sj, r[2], r[3]);
    if (bj == aj) {
      o[0] = o[1];
      o[2] = o[3];
    }
  } else {
    o[0] = r[0];
    o[1] = 0.f;
    o[2] = r[2];
    o[3] = 0.f;
  }
}

// The rows (ai, bi) of a 2 x 2 block x rotated by (ci, si): r[0..1] row
// ai, r[2..3] row bi (a degenerate pair's row is its q side, as the plain
// version's second scatter).
__device__ __forceinline__ void rotate_rows(const float x[4], int ai, int bi,
                                            int bj, float ci, float si,
                                            float r[4]) {
  r[0] = x[0];
  r[1] = x[1];
  r[2] = 0.f;
  r[3] = 0.f;
  if (bi >= 0) {
    r[0] = combine(0, ci, si, x[0], x[2]);
    r[2] = combine(1, ci, si, x[0], x[2]);
    if (bj >= 0) {
      r[1] = combine(0, ci, si, x[1], x[3]);
      r[3] = combine(1, ci, si, x[1], x[3]);
    }
    if (bi == ai) {
      r[0] = r[2];
      r[1] = r[3];
    }
  }
}

// The blocks of C (rows first, then columns) and of V (columns) at unit i
// x unit j of one round, from the same blocks before it, stored at batch
// offset `off` in the plain version's order (a degenerate pair's q side
// written last).
__device__ __forceinline__ void rotate_store(const float xc[4],
                                             const float xv[4], int ai,
                                             int bi, int aj, int bj, float ci,
                                             float si, float cj, float sj,
                                             float* Cd, float* Vd, size_t off,
                                             int n) {
  float r[4];
  rotate_rows(xc, ai, bi, bj, ci, si, r);
  const size_t ra = off + static_cast<size_t>(ai) * n;
  const size_t rb = off + static_cast<size_t>(bi) * n;
  if (bj >= 0) {
    Cd[ra + aj] = combine(0, cj, sj, r[0], r[1]);
    Cd[ra + bj] = combine(1, cj, sj, r[0], r[1]);
    Vd[ra + aj] = combine(0, cj, sj, xv[0], xv[1]);
    Vd[ra + bj] = combine(1, cj, sj, xv[0], xv[1]);
    if (bi >= 0) {
      Cd[rb + aj] = combine(0, cj, sj, r[2], r[3]);
      Cd[rb + bj] = combine(1, cj, sj, r[2], r[3]);
      Vd[rb + aj] = combine(0, cj, sj, xv[2], xv[3]);
      Vd[rb + bj] = combine(1, cj, sj, xv[2], xv[3]);
    }
  } else {
    Cd[ra + aj] = r[0];
    Vd[ra + aj] = xv[0];
    if (bi >= 0) {
      Cd[rb + aj] = r[2];
      Vd[rb + aj] = xv[2];
    }
  }
}

// The (c, s) of the unit (a, q) (q < 0: no pair) from C's entries, read
// through L2.
__device__ __forceinline__ void unit_angle(const float* Cb, int a, int q,
                                           int n, int mode, float* c,
                                           float* s) {
  *c = 1.f;
  *s = 0.f;
  if (q >= 0) {
    const size_t ra = static_cast<size_t>(a) * n;
    const size_t rq = static_cast<size_t>(q) * n;
    guarded_rotation(__ldcg(Cb + ra + q), __ldcg(Cb + ra + a),
                     __ldcg(Cb + rq + q), a, q, mode, c, s);
  }
}

// A round's pairs (loaded into pq) as a table: which coordinates they
// cover, and how many (`count`, a shared word).  Block-wide: every thread
// returns the same table.
__device__ __forceinline__ Table round_table(const int* pq, int* covered,
                                             int* count, int n, int k,
                                             int tid) {
  for (int i = tid; i < n; i += NT) covered[i] = 0;
  if (tid == 0) *count = 0;
  __syncthreads();
  int mine = 0;
  for (int j = tid; j < k; j += NT) {
    const int p = pq[2 * j];
    const int q = pq[2 * j + 1];
    if (in_range(p, q, n)) {
      covered[p] = 1;
      covered[q] = 1;
      mine += p == q ? 1 : 2;
    }
  }
  if (mine) atomicAdd(count, mine);
  __syncthreads();
  return Table{pq, covered, *count == n ? k : k + n};
}

// One round of table t over every tile of every problem: (Ci, Vi) ->
// (Cd, Vd).  A tile is UR x UX units; each block of threads computes its
// tile's UR + UX angles from the round's input: no angle phase, no second
// barrier.
__device__ __forceinline__ void one_round(const Table& t, const float* Ci,
                                          const float* Vi, float* Cd,
                                          float* Vd, float (*ang)[UR + UX],
                                          int batch, int n, int k,
                                          int mode) {
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * UX + x;
  const size_t nn = static_cast<size_t>(n) * n;
  const int urows = (t.units + UR - 1) / UR;
  const int ucols = (t.units + UX - 1) / UX;
  const int per_problem = urows * ucols;
  const int total = batch * per_problem;

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int b = tile / per_problem;
    const int tt = tile - b * per_problem;
    const int ur0 = (tt / ucols) * UR;
    const int uc0 = (tt % ucols) * UX;
    const float* Cb = Ci + b * nn;
    const float* Vb = Vi + b * nn;

    // this thread's column unit and two row units, and their blocks of C
    // and V, loaded before the angles are known
    int aj, bj, ai[2], bi[2];
    unit_of(uc0 + x, t, k, n, &aj, &bj);
    float xc[2][4] = {}, xv[2][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unit_of(ur0 + y + UY * h, t, k, n, &ai[h], &bi[h]);
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
      unit_of(tid < UR ? ur0 + tid : uc0 + tid - UR, t, k, n, &a, &q);
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
}

// The pair of round r among u - 1, u, u + 1 (pq0's k pairs) holding
// coordinate x, -1 for none; side: 0 where x is its p, 1 its q.
__device__ __forceinline__ int pair_near(int x, const int* pq0, int u, int k,
                                         int n, int* side) {
  const int lo = u > 0 ? u - 1 : 0;
  const int hi = u + 1 < k ? u + 1 : k - 1;
  for (int v = lo; v <= hi; ++v) {
    const int p = pq0[2 * v];
    const int q = pq0[2 * v + 1];
    if (!in_range(p, q, n)) continue;
    if (p == x || q == x) {
      *side = p == x ? 0 : 1;
      return v;
    }
  }
  return -1;
}

// Whether rounds pq0, pq1 (in shared memory) run as one two-round step:
// each covers every coordinate, and each pair u of pq1 takes its
// coordinates from pairs u - 1, u, u + 1 of pq0 (the circle method: each
// player moves one seat a round).  `count` is two zeroed shared words.
// Block-wide: every thread returns the same answer.
__device__ __forceinline__ bool stageable(const int* pq0, const int* pq1,
                                          int* count, int n, int k,
                                          int tid) {
  bool near = true;
  int c0 = 0, c1 = 0, side;
  for (int j = tid; j < k; j += NT) {
    const int p0 = pq0[2 * j], q0 = pq0[2 * j + 1];
    const int p = pq1[2 * j], q = pq1[2 * j + 1];
    if (in_range(p0, q0, n)) c0 += p0 == q0 ? 1 : 2;
    if (in_range(p, q, n)) c1 += p == q ? 1 : 2;
    near = near && in_range(p, q, n) &&
           pair_near(p, pq0, j, k, n, &side) >= 0 &&
           pair_near(q, pq0, j, k, n, &side) >= 0;
  }
  if (c0) atomicAdd(&count[0], c0);
  if (c1) atomicAdd(&count[1], c1);
  near = __syncthreads_and(near);
  return near && count[0] == n && count[1] == n;
}

// The unit among widened indices h - 1, h, h + 1 (coordinates wa, wb; wa
// < 0: no unit) holding coordinate x, -1 for none; side: 0 where x is its
// p, 1 its q.
__device__ __forceinline__ int unit_near(int x, const int* wa, const int* wb,
                                         int h, int* side) {
  for (int v = h - 1; v <= h + 1; ++v) {
    if (wa[v] < 0) continue;
    if (wa[v] == x || wb[v] == x) {
      *side = wa[v] == x ? 0 : 1;
      return v;
    }
  }
  return -1;
}

// The pair thread `tid` < UT stages for the tile at unit row ur0, column
// uc0 of a two-round step over rounds pr0, pr1 (global): round r's over
// the widened rows, then columns, then round r + 1's over the tile's rows,
// then columns; (-1, -1) past the k units.
__device__ __forceinline__ int2 stage_pair(const int32_t* pr0,
                                           const int32_t* pr1, int ur0,
                                           int uc0, int k, int tid) {
  int u = uc0 + tid - AT - UR;
  const int32_t* pr = pr1;
  if (tid < HR) {
    u = ur0 - 1 + tid;
    pr = pr0;
  } else if (tid < AT) {
    u = uc0 - 1 + tid - HR;
    pr = pr0;
  } else if (tid < AT + UR) {
    u = ur0 + tid - AT;
  }
  int2 v = make_int2(-1, -1);
  if (tid < UT && u >= 0 && u < k) {
    v.x = __ldg(pr + 2 * u);
    v.y = __ldg(pr + 2 * u + 1);
  }
  return v;
}

// Rounds r and r + 1 of a stageable step (pairs pr0, pr1 in global
// memory), with no grid barrier between them.  Each block takes the tiles
// of round r + 1.  A tile's rows and columns read round r's output only on
// its pair ranges widened by one, and its angles only the three
// near-diagonal entries of each pair; so the block computes round r on
// that widened tile from (Ci, Vi), with the same arithmetic on the same
// operands as one_round, keeps it in shared memory, and stores only round
// r + 1 to (Cd, Vd).  `first` holds the pair thread tid stages for the
// block's first tile, loaded a step ahead.
__device__ __forceinline__ void two_rounds(const int32_t* pr0,
                                           const int32_t* pr1, int2 first,
                                           const float* Ci, const float* Vi,
                                           float* Cd, float* Vd, float* stage,
                                           float (*ang)[UR + UX], int batch,
                                           int n, int k, int mode) {
  constexpr int CT = HR * HX;          // round r's blocks of C
  constexpr int VT = UR * HX;          // round r's blocks of V
  constexpr int ET = 3 * (UR + UX);    // entries of round r + 1's angles
  constexpr int PT = 2 * (UR + UX);    // the tile's coordinates
  constexpr int TASKS = 3;             // blocks of C and of V a thread
  constexpr int LD = 2 * HX;           // a staged row: the widened columns
  static_assert(CT <= TASKS * NT && VT <= TASKS * NT && ET + AT <= NT &&
                    PT <= NT && UT <= NT,
                "a block's threads cover the widened tile");
  // hc[(2 h + side) LD + 2 w + side]: C after round r at the coordinates
  // of row unit ur0 - 1 + h and column unit uc0 - 1 + w; hv likewise, its
  // rows the tile's own (2 i + side); first the loads, then in place the
  // rotated values
  float* hc = stage;
  float* hv = hc + 2 * HR * LD;
  float* ent = hv + 2 * UR * LD;       // [3][UR + UX]: (a b), (a a), (b b)
  float* ar = ent + 3 * (UR + UX);     // [2][AT]: round r's (c, s)
  int* pos = reinterpret_cast<int*>(ar + 2 * AT);  // [2 UR] rows, [2 UX]
                                                    // columns: hc's index
  // (a, b) of round r's units ur0 - 1 .. (HR), uc0 - 1 .. (HX), then of
  // round r + 1's ur0 .. (UR), uc0 .. (UX); a < 0: no unit
  int* ua = pos + PT;
  int* ub = ua + UT;
  const int* ra_ = ua;                 // round r, widened rows
  const int* rb_ = ub;
  const int* ca_ = ua + HR;            // round r, widened columns
  const int* cb_ = ub + HR;
  const int* ta_ = ua + AT;            // round r + 1, the tile's rows then
  const int* tb_ = ub + AT;            // its columns
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tid = y * UX + x;
  const size_t nn = static_cast<size_t>(n) * n;
  const int urows = (k + UR - 1) / UR;
  const int ucols = (k + UX - 1) / UX;
  const int per_problem = urows * ucols;
  const int total = batch * per_problem;

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int b = tile / per_problem;
    const int tt = tile - b * per_problem;
    const int ur0 = (tt / ucols) * UR;
    const int uc0 = (tt % ucols) * UX;
    const float* Cb = Ci + b * nn;
    const float* Vb = Vi + b * nn;

    // 0. the units' coordinates
    const int2 pair = tile == static_cast<int>(blockIdx.x)
                          ? first
                          : stage_pair(pr0, pr1, ur0, uc0, k, tid);
    if (tid < UT) {
      const bool live = in_range(pair.x, pair.y, n);
      ua[tid] = live ? pair.x : -1;
      ub[tid] = live ? pair.y : -1;
    }
    __syncthreads();

    // 1. every load of the step, before any angle is known: round r's
    // blocks of C over the widened tile and V's rows of the tile over the
    // widened columns (into the staging), the blocks holding the entries
    // of round r + 1's angles, and round r's angles
    auto stage_block = [&](const float* M, float* o, int a, int bb, int ca,
                           int cb) {
      if (a < 0 || ca < 0) return;
      float v[4];
      load_block(M, n, a, bb, ca, cb, v);
      o[0] = v[0];
      if (cb >= 0) o[1] = v[1];
      if (bb >= 0) {
        o[LD] = v[2];
        if (cb >= 0) o[LD + 1] = v[3];
      }
    };
#pragma unroll
    for (int i = 0; i < TASKS; ++i) {
      const int task = tid + i * NT;
      const int h = task / HX, w = task - h * HX;
      if (task < CT)
        stage_block(Cb, hc + 2 * h * LD + 2 * w, ra_[h], rb_[h], ca_[w],
                    cb_[w]);
      if (task < VT)
        stage_block(Vb, hv + 2 * h * LD + 2 * w, ta_[h], tb_[h], ca_[w],
                    cb_[w]);
    }
    // this thread's entry: coordinates (ex, ey) of unit e, their units of
    // round r (eu, ev, widened indices of e's side) and sides
    float xe[4] = {};
    int ex = -1, ey = -1, eu = 0, ev = 0, sx = 0, sy = 0;
    const int e = tid / 3;
    const int* wa = e < UR ? ra_ : ca_;
    const int* wb = e < UR ? rb_ : cb_;
    if (tid < ET) {
      const int a = ta_[e], bb = tb_[e];
      if (bb >= 0) {
        const int which = tid - 3 * e;
        const int h = e < UR ? e + 1 : e - UR + 1;
        ex = which == 2 ? bb : a;
        ey = which == 1 ? a : bb;
        eu = unit_near(ex, wa, wb, h, &sx);
        ev = unit_near(ey, wa, wb, h, &sy);
        load_block(Cb, n, wa[eu], wb[eu], wa[ev], wb[ev], xe);
      }
    } else if (tid < ET + AT) {
      const int h = tid - ET;
      float cc, ss;
      unit_angle(Cb, ua[h], ub[h], n, mode, &cc, &ss);
      ar[h] = cc;
      ar[AT + h] = ss;
    }
    if (tid < PT) {  // where the tile's coordinates lie in the staging
      const bool row = tid < 2 * UR;
      const int w = (row ? tid : tid - 2 * UR) >> 1;
      const int c = (tid & 1) ? tb_[row ? w : UR + w] : ta_[row ? w : UR + w];
      int at = 0, side = 0;
      if (c >= 0) {
        const int v = unit_near(c, row ? ra_ : ca_, row ? rb_ : cb_, w + 1,
                                &side);
        at = v < 0 ? 0 : 2 * v + side;
      }
      pos[tid] = at;
    }
    __syncthreads();

    // 2. round r on the widened tile, in place
#pragma unroll
    for (int i = 0; i < TASKS; ++i) {
      const int task = tid + i * NT;
      const int h = task / HX, w = task - h * HX;
      const int ca = ca_[w], cb = cb_[w];
      const float cj = ar[HR + w], sj = ar[AT + HR + w];
      float r[4], o[4];
      if (task < CT) {
        const int a = ra_[h], bb = rb_[h];
        if (a >= 0 && ca >= 0) {
          float* v = hc + 2 * h * LD + 2 * w;
          const float xv[4] = {v[0], v[1], v[LD], v[LD + 1]};
          rotate_rows(xv, a, bb, cb, ar[h], ar[AT + h], r);
          rotate_cols(r, ca, cb, cj, sj, o);
          v[0] = o[0];
          v[1] = o[1];
          v[LD] = o[2];
          v[LD + 1] = o[3];
        }
      }
      if (task < VT) {
        const int a = ta_[h];
        if (a >= 0 && ca >= 0) {
          float* v = hv + 2 * h * LD + 2 * w;
          const float xv[4] = {v[0], v[1], v[LD], v[LD + 1]};
          rotate_cols(xv, ca, cb, cj, sj, o);
          v[0] = o[0];
          v[1] = o[1];
          v[LD] = o[2];
          v[LD + 1] = o[3];
        }
      }
    }
    if (ex >= 0) {
      // the entry's block, by its pairs' angles in the widened range of
      // the tile's rows (a row unit) or columns (a column unit)
      const int lo = e < UR ? 0 : HR;
      float r[4], o[4];
      rotate_rows(xe, wa[eu], wb[eu], wb[ev], ar[lo + eu], ar[AT + lo + eu],
                  r);
      rotate_cols(r, wa[ev], wb[ev], ar[lo + ev], ar[AT + lo + ev], o);
      ent[(tid - 3 * e) * (UR + UX) + e] = o[2 * sx + sy];
    }
    __syncthreads();

    // 3. round r + 1's angles, from round r's entries
    if (tid < UR + UX) {
      const int a = ta_[tid], bb = tb_[tid];
      float cc = 1.f, ss = 0.f;
      if (bb >= 0) {
        guarded_rotation(ent[tid], ent[(UR + UX) + tid],
                         ent[2 * (UR + UX) + tid], a, bb, mode, &cc, &ss);
      }
      ang[0][tid] = cc;
      ang[1][tid] = ss;
    }
    __syncthreads();

    // 4. round r + 1 on the tile, stored
    const int aj = ta_[UR + x], bj = tb_[UR + x];
    const int c0 = pos[2 * UR + 2 * x], c1 = pos[2 * UR + 2 * x + 1];
    const float cj = ang[0][UR + x], sj = ang[1][UR + x];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = y + UY * h;
      const int ai = ta_[i], bi = tb_[i];
      if (ai < 0 || aj < 0) continue;
      const float* ra = hc + pos[2 * i] * LD;
      const float* rb = hc + pos[2 * i + 1] * LD;
      const float* va = hv + 2 * i * LD;
      const float* vb = va + LD;
      const float xc2[4] = {ra[c0], ra[c1], rb[c0], rb[c1]};
      const float xv2[4] = {va[c0], va[c1], vb[c0], vb[c1]};
      rotate_store(xc2, xv2, ai, bi, aj, bj, ang[0][i], ang[1][i], cj, sj,
                   Cd, Vd, b * nn, n);
    }
    __syncthreads();  // the staging is the next tile's
  }
}

// DEPTH rounds a grid barrier.  Step s takes rounds DEPTH s .. DEPTH s +
// DEPTH - 1 and writes buffer (S - 1 - s) % 2 of (out, spare), so the last
// step writes out; it reads what step s - 1 wrote, or the input.
// barrier[0] is the grid barrier's word; at depth 2, barrier[1 + s] says
// whether two-round step s is stageable.  The blocks check those steps
// once, before the first (each its share; every block checks step 0, as
// the others' answers are read only after the first barrier).  A step
// that is not runs its two rounds one barrier apart through the third
// buffer (Ct, Vt); an odd R ends on a single round.  Block 0 adds the grid
// barriers it passed to *issued (where not null).  Three blocks an SM at
// either depth: the fit's 325 tiles resident at once at two rounds a
// barrier, and one round a barrier at the occupancy it had as a kernel of
// its own (unbounded, this instance took 93 registers, two blocks an SM,
// and a 32 x 256 sweep 4% longer).
template <int DEPTH>
__global__ void __launch_bounds__(NT, 3)
sweep_grid_kernel(const float* C, const float* V,
                  const int32_t* __restrict__ pairs, float* Co, float* Vo,
                  float* Cs, float* Vs, float* Ct, float* Vt,
                  unsigned int* barrier, unsigned long long* issued,
                  int batch, int n, int k, int rounds, int mode) {
  extern __shared__ int table[];
  int* pq = table;                    // the step's pairs, round by round
  int* covered = table + DEPTH * 2 * k;  // coordinate -> in a live pair
  __shared__ int count[DEPTH];
  __shared__ float ang[2][UR + UX];   // (c, s) of the tile's row units,
                                      // then its column units
  const int tid = threadIdx.y * UX + threadIdx.x;
  const int steps = (rounds + DEPTH - 1) / DEPTH;
  int passed = 0;  // grid barriers

  if constexpr (DEPTH == 1) {
    // the next round's first PREFETCH * NT pair entries, loaded while this
    // round computes (the pairs are never written)
    int ahead[PREFETCH];
    auto load_ahead = [&](int round) {
      const int32_t* pr = pairs + static_cast<size_t>(round) * k * 2;
#pragma unroll
      for (int e = 0; e < PREFETCH; ++e) {
        const int i = tid + e * NT;
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
        const int i = tid + e * NT;
        if (i < 2 * k) pq[i] = ahead[e];
      }
      for (int i = tid + PREFETCH * NT; i < 2 * k; i += NT)
        pq[i] = __ldg(pr + i);
      for (int i = tid; i < n; i += NT) covered[i] = 0;
      if (tid == 0) count[0] = 0;
      __syncthreads();
      if (round + 1 < rounds) load_ahead(round + 1);
      int mine = 0;
      for (int j = tid; j < k; j += NT) {
        const int p = pq[2 * j];
        const int q = pq[2 * j + 1];
        if (in_range(p, q, n)) {
          covered[p] = 1;
          covered[q] = 1;
          mine += p == q ? 1 : 2;
        }
      }
      if (mine) atomicAdd(&count[0], mine);
      __syncthreads();
      const Table t = {pq, covered, count[0] == n ? k : k + n};
      one_round(t, Ci, Vi, Cd, Vd, ang, batch, n, k, mode);
      if (round + 1 < rounds) {
        grid_barrier(barrier);
        ++passed;
      }
    }
  } else {
    float* stage = reinterpret_cast<float*>(covered + n);
    unsigned int* staged = barrier + 1;
    const int full = rounds / 2;       // steps of two rounds
    auto check = [&](int s) {          // block-wide
      const int32_t* pr = pairs + static_cast<size_t>(s) * 4 * k;
      for (int i = tid; i < 4 * k; i += NT) pq[i] = __ldg(pr + i);
      if (tid < 2) count[tid] = 0;
      __syncthreads();
      const bool ok = stageable(pq, pq + 2 * k, count, n, k, tid);
      __syncthreads();                 // pq and count are reused
      return ok;
    };
    const bool staged0 = full > 0 && check(0);
    for (int s = 1 + blockIdx.x; s < full; s += gridDim.x) {
      const bool ok = check(s);
      if (tid == 0) staged[s] = ok;
    }
    // the block's first tile at a two-round step (units = k), whose pairs
    // each thread loads a step ahead
    const int ucols = (k + UX - 1) / UX;
    const int tt = blockIdx.x % (((k + UR - 1) / UR) * ucols);
    const int ur0 = (tt / ucols) * UR, uc0 = (tt % ucols) * UX;
    const size_t per_round = static_cast<size_t>(k) * 2;
    int2 next = full > 0 ? stage_pair(pairs, pairs + per_round, ur0, uc0, k,
                                      tid)
                         : make_int2(-1, -1);
    unsigned int next_staged = 0;

    for (int step = 0; step < steps; ++step) {
      const bool to_spare = ((steps - 1 - step) & 1) != 0;
      const float* Ci = step == 0 ? C : (to_spare ? Co : Cs);
      const float* Vi = step == 0 ? V : (to_spare ? Vo : Vs);
      float* Cd = to_spare ? Cs : Co;
      float* Vd = to_spare ? Vs : Vo;
      const int first = 2 * step;
      const int32_t* pr = pairs + first * per_round;
      const int2 mine = next;
      bool two = false;
      if (step < full) {
        two = step == 0 ? staged0
                        : (step == 1 ? __ldcg(staged + 1) : next_staged) != 0;
      }
      if (step + 1 < full) {
        next = stage_pair(pr + 2 * per_round, pr + 3 * per_round, ur0, uc0,
                          k, tid);
        if (step >= 1) next_staged = __ldcg(staged + step + 1);
      }
      if (two) {
        two_rounds(pr, pr + per_round, mine, Ci, Vi, Cd, Vd, stage, ang,
                   batch, n, k, mode);
      } else {
        const int count_rounds = step < full ? 2 : 1;
        for (int i = tid; i < count_rounds * 2 * k; i += NT)
          pq[i] = __ldg(pr + i);
        if (count_rounds == 1) {
          one_round(round_table(pq, covered, &count[0], n, k, tid), Ci, Vi,
                    Cd, Vd, ang, batch, n, k, mode);
        } else {
          one_round(round_table(pq, covered, &count[0], n, k, tid), Ci, Vi,
                    Ct, Vt, ang, batch, n, k, mode);
          grid_barrier(barrier);  // also: every block is done with covered
          ++passed;
          one_round(round_table(pq + 2 * k, covered, &count[0], n, k, tid),
                    Ct, Vt, Cd, Vd, ang, batch, n, k, mode);
        }
      }
      if (step + 1 < steps) {
        grid_barrier(barrier);
        ++passed;
      }
    }
  }
  if (issued && blockIdx.x == 0 && tid == 0)
    atomicAdd(issued, static_cast<unsigned long long>(passed));
}

using GridKernel = decltype(&sweep_grid_kernel<1>);

GridKernel grid_kernel(int depth) {
  return depth == 2 ? sweep_grid_kernel<2> : sweep_grid_kernel<1>;
}

// Blocks of the grid kernel at `depth` an SM holds at (n, k); 0 where its
// shared memory exceeds the opt-in limit.
cudaError_t grid_blocks_per_sm(int n, int k, int depth, int smem_optin,
                               int* blocks) {
  *blocks = 0;
  const size_t bytes = grid_smem_bytes(n, k, depth);
  if (bytes > static_cast<size_t>(smem_optin)) return cudaSuccess;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        static_cast<cudaError_t>(repro::allow_smem(grid_kernel(depth), bytes));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, grid_kernel(depth), NT, bytes);
}

}  // namespace

// Limits the wrapper plans with: the opt-in shared memory of one block,
// the SM count, and how many blocks of the grid kernel an SM holds at this
// (n, k) at one round a barrier and at two (0 where the staging does not
// fit); cooperative launch must be supported.
extern "C" int repro_jacobi_sweep_limits(int n, int k, int* smem_optin,
                                         int* sms, int* grid_blocks,
                                         int* staged_blocks) {
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
  if (err == cudaSuccess)
    err = grid_blocks_per_sm(n, k, 1, *smem_optin, grid_blocks);
  if (err == cudaSuccess)
    err = grid_blocks_per_sm(n, k, 2, *smem_optin, staged_blocks);
  return static_cast<int>(err);
}

// R = rounds rounds of the (R, k, 2) int32 pairs over (C, V) -> (Co, Vo);
// mode: 0 rutishauser, 1 atan2, 2 cordic.  smem != 0: the shared-memory
// kernel, one block per problem (grid and depth ignored).  smem == 0: the
// grid kernel with `grid` blocks, all resident at once, `depth` (1 or 2)
// rounds a grid barrier, ping-ponging between (Co, Vo) and the spare
// (Cs, Vs) (unused when R <= depth).  `barrier`: zeroed words, one at
// depth 1, 1 + R / 2 at depth 2 (the step flags).  At depth 2, (Ct, Vt)
// is the third buffer of a step that runs one round a barrier (it may be
// the spare when R == 2).  The grid barriers the launch passes are added
// to *issued unless it is null.  The outputs and buffers must not alias
// C/V or each other.
extern "C" int repro_jacobi_sweep(const float* C, const float* V,
                                  const int32_t* pairs, float* Co, float* Vo,
                                  float* Cs, float* Vs, float* Ct, float* Vt,
                                  unsigned int* barrier,
                                  unsigned long long* issued, int batch, int n,
                                  int k, int rounds, int mode, int smem,
                                  int grid, int depth, void* stream) {
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
  if (depth != 1 && depth != 2) return static_cast<int>(cudaErrorInvalidValue);
  const GridKernel kernel = grid_kernel(depth);
  const size_t bytes = grid_smem_bytes(n, k, depth);
  if (bytes > 48 * 1024) {
    int status = repro::allow_smem(kernel, bytes);
    if (status) return status;
  }
  // Under stream capture (a CUDA graph of the serving engine) the launch
  // becomes a kernel node that keeps the cooperative attribute: the grid
  // barrier needs every block resident at once at each replay too.
  cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
  cudaError_t err = cudaStreamIsCapturing(s, &capturing);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capturing != cudaStreamCaptureStatusNone) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(UX, UY);
    config.dynamicSmemBytes = bytes;
    config.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, C, V, pairs, Co, Vo, Cs, Vs, Ct,
                             Vt, barrier, issued, batch, n, k, rounds,
                             mode);
    if (err != cudaSuccess) {
      (void)cudaGetLastError();
      return static_cast<int>(err);
    }
    return repro::launch_status();
  }
  void* args[] = {&C,       &V,      &pairs, &Co, &Vo, &Cs,     &Vs,   &Ct,
                  &Vt,      &barrier, &issued, &batch, &n, &k, &rounds, &mode};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(UX, UY), args, bytes, s);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // clear it: the wrapper raises
    return static_cast<int>(err);
  }
  return repro::launch_status();
}
