// Max |off-diagonal| pivot search over an (n, n) fp32 matrix in one
// launch: the value, its flat index p * n + q, and the pivot the Jacobi
// step needs (p, q, C[p, q], C[p, p], C[q, q]).
//
// Replaces the TPU kernel repro/kernels/dle.py::dle_scan (body
// _dle_kernel): a sequential grid walks T x T tiles in row-major order,
// masks the diagonal and the padding to -1, takes each tile's max and first
// argmax, and replaces a running best held in SMEM only when the tile's max
// is strictly greater.  A tile whose max is NaN (a NaN in a valid entry)
// never compares greater, so it is skipped whole.  Hopper blocks run in
// parallel and in no order, so that order is carried by a key:
//
//   key = |v| bits << 32 | (POS_TOP - position in the tile) << 1 | sign of v
//
// For a non-negative float the bit pattern orders as the value, and the
// reversed position makes the first maximum of a tile the largest key; the
// sign bit, below the position, breaks no tie and gives back C[p, q]
// without a load.  A NaN gets NAN_KEY, above every other key; 0 is "no
// candidate".
//
// The grid fills the card: a block takes ROWS rows x COLS columns inside
// one tile (the ragged edge masked, nothing padded): 7 x 49 = 343 blocks
// at n = 784, tile 128.  A lane reads 4 elements a row, one 16-byte load
// where the wrapper found n, tile and the base 16-byte aligned (VEC 4),
// else 4 loads 32 columns apart (VEC 1); indices come from the loop
// counters, with no division per element.  A block takes the max of its
// keys and folds it into its tile's slot with one 64-bit atomicMax, then
// takes a ticket (acquire-release).  The last block reads the slots in
// tile order, skips NaN tiles, keeps the larger value and on a tie the
// earlier tile (the strictly-greater rule of the running best), takes
// C[p, p] and C[q, q] from the diagonal it read while the slots were on
// their way (n <= DIAG; else from C), writes the pivot, and zeroes the
// slots and the ticket, so the scratch is clean for the next launch on its
// stream.  With no candidate (n = 1, or every tile NaN) the result is
// (-1, 0) and the pivot (0, 0, C[0,0], C[0,0], C[0,0]).
//
// Bound: C read once, 4 n^2 bytes (2.46 MB at n = 784, 0.73 us at
// 3.35 TB/s).  At that size the kernel is a chain of latencies: the loads,
// the block's atomic and ticket, the last block's pass over 49 slots.
#include <cuda/atomic>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;   // rows a block, ROWS / WARPS a warp
constexpr int COLS = 128;  // columns a block: 4 a lane
constexpr int DIAG = 1024;  // the last block keeps C's diagonal up to this n
constexpr unsigned long long NAN_KEY = 0xffffffffffffffffull;
constexpr unsigned int POS_TOP = 0x7fffffffu;  // above every position
static_assert(DIAG % THREADS == 0 && ROWS % WARPS == 0, "block shape");

struct Pivot {  // the wrapper's (5,) int64 output
  long long p, q;
  float c_pq, c_pp, c_qq, value;
  int index, unused;
};

__device__ __forceinline__ unsigned long long key_of(float v, int pos) {
  const unsigned int bits = __float_as_uint(v);
  const unsigned int mag = bits & 0x7fffffffu;
  if (mag > 0x7f800000u) return NAN_KEY;
  return static_cast<unsigned long long>(mag) << 32 |
         (POS_TOP - static_cast<unsigned int>(pos)) << 1 | bits >> 31;
}

__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a > b ? a : b;
}

// scratch[0] is the ticket, scratch[1 + t] tile t's slot; both zero between
// launches
template <int VEC>
__global__ void __launch_bounds__(THREADS)
dle_kernel(const float* __restrict__ c, Pivot* __restrict__ out,
           unsigned long long* __restrict__ scratch, int n, int tile, int g,
           int chunks, int strips) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tj = blockIdx.x / chunks;
  const int ti = blockIdx.y / strips;
  const int c0 = tj * tile + (blockIdx.x - tj * chunks) * COLS;
  const int r0 = ti * tile + (blockIdx.y - ti * strips) * ROWS;
  const int c1 = min(min(c0 + COLS, tj * tile + tile), n);
  const int r1 = min(min(r0 + ROWS, ti * tile + tile), n);
  constexpr int PASSES = ROWS / WARPS;

  float x[PASSES][4];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int r = r0 + warp + i * WARPS;
    const float* row = c + static_cast<size_t>(r) * n;
    if (VEC == 4) {
      const int col = c0 + 4 * lane;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < r1 && col < c1)
        v = __ldg(reinterpret_cast<const float4*>(row + col));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + lane + 32 * e;
        x[i][e] = r < r1 && col < c1 ? __ldg(row + col) : 0.f;
      }
    }
  }
  unsigned long long best = 0;
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int r = r0 + warp + i * WARPS;
    // position within the tile of column 0 of this row
    const int base = (r - ti * tile) * tile - tj * tile;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = VEC == 4 ? c0 + 4 * lane + e : c0 + lane + 32 * e;
      if (r < r1 && col < c1 && col != r)
        best = max64(best, key_of(x[i][e], base + col));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max64(best, __shfl_xor_sync(0xffffffffu, best, off));
  __shared__ unsigned long long warp_best[WARPS];
  __shared__ unsigned int warp_low[WARPS];
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();

  // one atomicMax a block (with eight a block the slots' queues cost a
  // microsecond); the same thread takes a ticket, acquire-release at the
  // device's scope, so the last block sees every slot
  unsigned long long* slots = scratch + 1;
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) best = max64(best, warp_best[w]);
    if (best) atomicMax(slots + ti * g + tj, best);
    const unsigned long long blocks =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> ticket(
        scratch[0]);
    last = ticket.fetch_add(1, cuda::memory_order_acq_rel) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: the diagonal (for C[p, p] and C[q, q]) is read while
  // the slots are; then the tiles in order, a candidate's key being
  // (value, ~tile), so the larger value and then the earlier tile wins
  __shared__ float diag[DIAG];
  float d[DIAG / THREADS];
  const bool cached = n <= DIAG;
#pragma unroll
  for (int k = 0; k < DIAG / THREADS; ++k) {
    const int i = threadIdx.x + k * THREADS;
    d[k] = cached && i < n ? __ldg(c + static_cast<size_t>(i) * (n + 1))
                           : 0.f;
  }
  const int tiles = g * g;
  unsigned long long top = 0;
  unsigned int low = 0;
  for (int t = threadIdx.x; t < tiles; t += THREADS) {
    const unsigned long long s = __ldcg(slots + t);
    if (!s) continue;
    slots[t] = 0;
    const unsigned long long k =
        (s & 0xffffffff00000000ull) | static_cast<unsigned int>(~t);
    if (s != NAN_KEY && k > top) {
      top = k;
      low = static_cast<unsigned int>(s);
    }
  }
#pragma unroll
  for (int k = 0; k < DIAG / THREADS; ++k)
    diag[threadIdx.x + k * THREADS] = d[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long k = __shfl_xor_sync(0xffffffffu, top, off);
    const unsigned int o = __shfl_xor_sync(0xffffffffu, low, off);
    if (k > top) {
      top = k;
      low = o;
    }
  }
  if (lane == 0) {
    warp_best[warp] = top;
    warp_low[warp] = low;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < WARPS; ++w) {
    if (warp_best[w] > top) {
      top = warp_best[w];
      low = warp_low[w];
    }
  }
  long long p = 0, q = 0;
  float value = -1.f;
  float c_pq = cached ? diag[0] : c[0];
  if (top) {
    const int t = static_cast<int>(~static_cast<unsigned int>(top));
    const int bi = t / g;
    const int pos = static_cast<int>(POS_TOP - (low >> 1));
    const int lr = pos / tile;
    p = static_cast<long long>(bi) * tile + lr;
    q = static_cast<long long>(t - bi * g) * tile + (pos - lr * tile);
    const unsigned int mag = static_cast<unsigned int>(top >> 32);
    value = __uint_as_float(mag);
    c_pq = __uint_as_float(mag | low << 31);  // C[p, q] with its sign
  }
  out->p = p;
  out->q = q;
  out->c_pq = c_pq;
  out->c_pp = cached ? diag[p] : c[p * n + p];
  out->c_qq = cached ? diag[q] : c[q * n + q];
  out->value = value;
  out->index = static_cast<int>(p * n + q);
  out->unused = 0;
  scratch[0] = 0;
}

}  // namespace

// out: 40 bytes (struct Pivot); scratch: 1 + ceil(n / tile)^2 zeroed
// uint64; vec: 4 where n % 4 == 0, tile % 4 == 0 and c is 16-byte aligned,
// else 1.
extern "C" int repro_dle_pivot(const float* c, void* out,
                               unsigned long long* scratch, int n, int tile,
                               int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = (n + tile - 1) / tile;
  const int edge = n - (g - 1) * tile;  // width of the last tile row/col
  const int chunks = (tile + COLS - 1) / COLS;
  const int strips = (tile + ROWS - 1) / ROWS;
  const dim3 grid((g - 1) * chunks + (edge + COLS - 1) / COLS,
                  (g - 1) * strips + (edge + ROWS - 1) / ROWS);
  Pivot* o = static_cast<Pivot*>(out);
  if (vec == 4)
    dle_kernel<4><<<grid, THREADS, 0, s>>>(c, o, scratch, n, tile, g, chunks,
                                          strips);
  else
    dle_kernel<1><<<grid, THREADS, 0, s>>>(c, o, scratch, n, tile, g, chunks,
                                          strips);
  return repro::launch_status();
}
