// Max |off-diagonal| pivot search over an (n, n) fp32 matrix: returns the
// value (fp32) and its flat index p * n + q (int32).
//
// Replaces the TPU kernel repro/kernels/dle.py::dle_scan (body
// _dle_kernel): a sequential grid walks T x T tiles in row-major order,
// masks the diagonal and the padding to -1, takes each tile's max and first
// argmax, and replaces a running best held in SMEM only on a strictly
// greater value.  Hopper blocks run in parallel and in no order, so the
// scan is two launches with that order rebuilt in the reductions:
//
//   1. tile_kernel: one block per tile writes (max, flat index of the first
//      maximum in row-major order within the tile); invalid entries are -1.
//      The ragged edge is masked by index, so nothing is padded or copied.
//   2. reduce_kernel: one block takes the larger value over the tiles and,
//      on a tie, the lower tile in row-major order -- the strictly-greater
//      rule of the running best.  If no entry is valid (n = 1) the result
//      is (-1, 0), the reset value of the TPU kernel's register.
//
// Bound: C read once, 4 n^2 bytes (2.46 MB at n = 784, 0.73 us at
// 3.35 TB/s); consecutive threads read consecutive columns of a tile row.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// (value, order): the larger value wins; on a tie the lower order
__device__ __forceinline__ void take(float& val, int& ord, float v, int o) {
  if (v > val || (v == val && o < ord)) {
    val = v;
    ord = o;
  }
}

__device__ void block_argmax(float& val, int& ord) {
  __shared__ float sv[THREADS / 32];
  __shared__ int so[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    take(val, ord, __shfl_down_sync(0xffffffffu, val, off),
         __shfl_down_sync(0xffffffffu, ord, off));
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    sv[warp] = val;
    so[warp] = ord;
  }
  __syncthreads();
  if (warp == 0) {
    val = lane < THREADS / 32 ? sv[lane] : -2.f;
    ord = lane < THREADS / 32 ? so[lane] : INT32_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take(val, ord, __shfl_down_sync(0xffffffffu, val, off),
           __shfl_down_sync(0xffffffffu, ord, off));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tile_kernel(const float* __restrict__ c, float* __restrict__ tile_val,
            int* __restrict__ tile_idx, int n, int tile, int grid_n) {
  const int ti = blockIdx.y;
  const int tj = blockIdx.x;
  float best = -2.f;  // below every candidate, so element 0 always enters
  int best_e = INT32_MAX;
  // each thread walks its elements in increasing row-major order and keeps
  // the first maximum it meets
  for (int e = threadIdx.x; e < tile * tile; e += THREADS) {
    const int r = ti * tile + e / tile;
    const int col = tj * tile + e % tile;
    float v = -1.f;
    if (r < n && col < n && r != col)
      v = fabsf(c[static_cast<size_t>(r) * n + col]);
    if (v > best) {
      best = v;
      best_e = e;
    }
  }
  block_argmax(best, best_e);
  if (threadIdx.x == 0) {
    const int r = ti * tile + best_e / tile;
    const int col = tj * tile + best_e % tile;
    tile_val[ti * grid_n + tj] = best;
    tile_idx[ti * grid_n + tj] = r * n + col;
  }
}

__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ tile_val,
              const int* __restrict__ tile_idx, float* __restrict__ val_out,
              int* __restrict__ idx_out, int tiles) {
  float best = -2.f;
  int best_t = INT32_MAX;
  for (int t = threadIdx.x; t < tiles; t += THREADS) {
    take(best, best_t, tile_val[t], t);
  }
  block_argmax(best, best_t);
  if (threadIdx.x == 0) {
    const bool found = best > -1.f;
    *val_out = found ? best : -1.f;
    *idx_out = found ? tile_idx[best_t] : 0;
  }
}

}  // namespace

// tile_val / tile_idx are (grid_n * grid_n) scratch; val / idx one element.
extern "C" int repro_dle_scan(const float* c, float* tile_val, int* tile_idx,
                              float* val, int* idx, int n, int tile,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid_n = (n + tile - 1) / tile;
  tile_kernel<<<dim3(grid_n, grid_n), THREADS, 0, s>>>(c, tile_val, tile_idx,
                                                      n, tile, grid_n);
  int status = repro::launch_status();
  if (status) return status;
  reduce_kernel<<<1, THREADS, 0, s>>>(tile_val, tile_idx, val, idx,
                                      grid_n * grid_n);
  return repro::launch_status();
}
