// Split-KV attention for decode: q (BH, Sq, D) with Sq <= 16, k/v
// (BH, Skv, D) of fp32 or bf16 -> out (BH, Sq, D) in q's dtype; every
// step in fp32, D <= 128.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel) for decode, where a 64-row q tile would use one row
// and 16 blocks would leave most of the card idle.  Two launches:
//
//   1. partial: a (split, bh) grid; each block covers one fixed run of up
//      to SPLIT keys.  It stages 64 keys of K and V at a time in shared
//      memory as fp32 (16-byte loads where D and the dtype keep rows
//      16-byte aligned, 8, 4 or element-wide loads elsewhere, several in
//      flight a thread), scores them against all Sq <= 16 query rows, and
//      keeps an online softmax per row.  It writes the split's (m, l,
//      acc[D]) per (bh, row) to fp32 scratch that the wrapper allocates.
//   2. merge: one block per (bh, row) combines the splits in split order
//      (a fixed order, so the result does not change from run to run)
//      and writes acc / max(l, 1e-30).
//
// Masking follows the dense oracle (kernels/ref.py::flash_attention): a
// causal score above the diagonal is -1e30.  A split whose keys are all
// masked still takes part in the merge, with m = -1e30 and l = its key
// count, so a row that sees no key gets the mean of all Skv values, as in
// the oracle.  A split with no keys at all (l = 0) takes no part.  Keys
// past the last one any row sees are not visited when every row sees key
// 0 (their weights are then exactly zero); the wrapper sizes the grid to
// the keys visited, kv_end.
//
// Bound: bytes.  K and V are read once: BH 16 x 4096 keys x 128 x 2
// tensors = 33.6 MB in bf16, 0.0100 ms at 3.35 TB/s (0.0200 ms in fp32);
// the arithmetic, 4 BH Sq Skv D operations, is 3.4e7 for one query row.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int SPLIT = 256;   // keys a block of the partial launch
constexpr int CHUNK = 64;    // keys staged in shared memory at a time
constexpr int MAX_SQ = 16;   // query rows a launch serves
constexpr int THREADS = 128;
constexpr int BATCH = 8;     // global loads a thread keeps in flight
constexpr float kMasked = -1e30f;  // the reference's mask value

template <int B>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows r0 .. r0 + n_rows - 1 of M (*, d) matrices g[m] into s[m] (row
// stride ld) as fp32; rows at or past r_end become zeros.  VB bytes a
// load; the loads of all M matrices are in flight together.
template <typename T, int VB, int M>
__device__ __forceinline__ void stage_rows(float* const (&s)[M],
                                           const T* const (&g)[M], int ld,
                                           int r0, int n_rows, int r_end,
                                           int d) {
  using R = typename Raw<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int per_row = d / E;
  const int total = n_rows * per_row;
  for (int base = threadIdx.x; base < total; base += THREADS * BATCH) {
    R raw[M][BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {  // all loads first, then the stores
      const int e = base + u * THREADS;
      const int r = e / per_row;
      const bool live = e < total && r0 + r < r_end;
      const size_t off =
          static_cast<size_t>(r0 + r) * d + (e % per_row) * E;
#pragma unroll
      for (int m = 0; m < M; ++m)
        raw[m][u] = live ? *reinterpret_cast<const R*>(g[m] + off) : R{};
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = base + u * THREADS;
      if (e >= total) break;
      const int at = (e / per_row) * ld + (e % per_row) * E;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const T* el = reinterpret_cast<const T*>(&raw[m][u]);
#pragma unroll
        for (int i = 0; i < E; ++i) s[m][at + i] = repro::to_float(el[i]);
      }
    }
  }
}

// the scores of one chunk: key j = tid % 64 against rows tid / 64 + 2 i,
// i < RP (2 RP >= sq); a masked score is -1e30, a key past the chunk's n
// live ones -inf
template <int RP>
__device__ __forceinline__ void score_chunk(const float* Qs, const float* Ks,
                                            float* Ps, int ld, int d, int sq,
                                            int n, int c0, float scale,
                                            int causal, int q_offset) {
  const int j = threadIdx.x % CHUNK;
  const int r0 = threadIdx.x / CHUNK;
  if (r0 >= sq) return;
  float s[RP];
#pragma unroll
  for (int i = 0; i < RP; ++i) s[i] = 0.f;
  for (int dd = 0; dd < d; ++dd) {
    const float kv = Ks[j * ld + dd];
#pragma unroll
    for (int i = 0; i < RP; ++i)
      s[i] = fmaf(Qs[(r0 + 2 * i) * ld + dd], kv, s[i]);
  }
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int r = r0 + 2 * i;
    if (r >= sq) break;
    float val = s[i] * scale;
    if (causal && r + q_offset < c0 + j) val = kMasked;
    if (j >= n) val = -INFINITY;  // no key: weight exactly 0
    Ps[r * CHUNK + j] = val;
  }
}

__host__ __device__ constexpr int ld_of(int d) { return d + 1; }

__host__ __device__ constexpr size_t partial_smem_floats(int d) {
  // Q, K, V, P, then m, l and alpha per row
  return static_cast<size_t>(MAX_SQ + 2 * CHUNK) * ld_of(d) +
         MAX_SQ * CHUNK + 3 * MAX_SQ;
}

// part: m (rows, n_split), l (rows, n_split), acc (rows, n_split, d) with
// rows = bh * sq
template <typename T, int VB>
__global__ void __launch_bounds__(THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ part,
                      int bh_count, int sq, int skv, int kv_end, int d,
                      float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int ld = ld_of(d);
  float* Qs = smem;
  float* Ks = Qs + MAX_SQ * ld;
  float* Vs = Ks + CHUNK * ld;
  float* Ps = Vs + CHUNK * ld;
  float* Ms = Ps + MAX_SQ * CHUNK;
  float* Ls = Ms + MAX_SQ;
  float* As = Ls + MAX_SQ;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k_begin = split * SPLIT;
  const int k_stop = min(kv_end, k_begin + SPLIT);
  const T* kb = k + static_cast<size_t>(bh) * skv * d;
  const T* vb = v + static_cast<size_t>(bh) * skv * d;

  {
    float* const dst[1] = {Qs};
    const T* const src[1] = {q + static_cast<size_t>(bh) * sq * d};
    stage_rows<T, VB, 1>(dst, src, ld, 0, sq, sq, d);
  }
  if (tid < MAX_SQ) {
    Ms[tid] = kMasked;
    Ls[tid] = 0.f;
  }
  float acc[MAX_SQ];
#pragma unroll
  for (int r = 0; r < MAX_SQ; ++r) acc[r] = 0.f;

  for (int c0 = k_begin; c0 < k_stop; c0 += CHUNK) {
    __syncthreads();  // the last chunk's K, V and P are no longer read
    const int n = min(CHUNK, k_stop - c0);
    {
      float* const dst[2] = {Ks, Vs};
      const T* const src[2] = {kb, vb};
      stage_rows<T, VB, 2>(dst, src, ld, c0, CHUNK, k_stop, d);
    }
    __syncthreads();

    switch ((sq + 1) / 2) {  // rows a thread scores: 2 RP >= sq
      case 1:
        score_chunk<1>(Qs, Ks, Ps, ld, d, sq, n, c0, scale, causal, q_offset);
        break;
      case 2:
        score_chunk<2>(Qs, Ks, Ps, ld, d, sq, n, c0, scale, causal, q_offset);
        break;
      case 3:
      case 4:
        score_chunk<4>(Qs, Ks, Ps, ld, d, sq, n, c0, scale, causal, q_offset);
        break;
      default:
        score_chunk<8>(Qs, Ks, Ps, ld, d, sq, n, c0, scale, causal, q_offset);
    }
    __syncthreads();

    // the online softmax: warp w takes rows w, w + 4, ...
    for (int r = warp; r < sq; r += THREADS / 32) {
      float a = Ps[r * CHUNK + lane];
      float b = Ps[r * CHUNK + lane + 32];
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      a = expf(a - m_new);
      b = expf(b - m_new);
      Ps[r * CHUNK + lane] = a;
      Ps[r * CHUNK + lane + 32] = b;
      const float sum = warp_sum(a + b);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[r] = alpha;
        Ls[r] = alpha * Ls[r] + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    if (tid < d) {  // thread tid owns output column tid of every row
#pragma unroll
      for (int r = 0; r < MAX_SQ; ++r) {
        if (r >= sq) break;
        float a = acc[r] * As[r];
        for (int jj = 0; jj < n; ++jj)
          a = fmaf(Ps[r * CHUNK + jj], Vs[jj * ld + tid], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  const size_t rows = static_cast<size_t>(bh_count) * sq;
  float* pm = part;
  float* pl = part + rows * n_split;
  float* pacc = part + 2 * rows * n_split;
#pragma unroll
  for (int r = 0; r < MAX_SQ; ++r) {  // constant indices keep acc in registers
    if (r >= sq) break;
    const size_t slot = (static_cast<size_t>(bh) * sq + r) * n_split + split;
    if (tid == 0) {
      pm[slot] = Ms[r];
      pl[slot] = Ls[r];
    }
    if (tid < d) pacc[slot * d + tid] = acc[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out,
                    int rows, int d, int n_split) {
  const int row = blockIdx.x;  // bh * sq + query row
  const int tid = threadIdx.x;
  if (tid >= d) return;
  const float* pm = part + static_cast<size_t>(row) * n_split;
  const float* pl = part + static_cast<size_t>(rows) * n_split +
                    static_cast<size_t>(row) * n_split;
  const float* pacc = part + 2 * static_cast<size_t>(rows) * n_split +
                      static_cast<size_t>(row) * n_split * d;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (pl[s] > 0.f) m = fmaxf(m, pm[s]);
  float l = 0.f;
  float acc = 0.f;
  for (int s = 0; s < n_split; ++s) {
    if (pl[s] > 0.f) {  // a split with no keys takes no part
      const float w = expf(pm[s] - m);
      l = fmaf(w, pl[s], l);
      acc = fmaf(w, pacc[static_cast<size_t>(s) * d + tid], acc);
    }
  }
  out[static_cast<size_t>(row) * d + tid] =
      repro::from_float<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int VB>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int bh, int sq, int skv, int kv_end, int d,
           float scale, int causal, int q_offset, int n_split,
           cudaStream_t s) {
  const size_t bytes = sizeof(float) * partial_smem_floats(d);
  const int err = repro::allow_smem(decode_partial_kernel<T, VB>, bytes);
  if (err) return err;
  decode_partial_kernel<T, VB><<<dim3(n_split, bh), THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, bh, sq, skv, kv_end, d, scale, causal,
      q_offset);
  const int status = repro::launch_status();
  if (status) return status;
  decode_merge_kernel<T><<<bh * sq, THREADS, 0, s>>>(
      part, static_cast<T*>(out), bh * sq, d, n_split);
  return repro::launch_status();
}

// the widest load (16, 8, 4 or 2 bytes) that every row start allows
int load_bytes(const void* q, const void* k, const void* v, int d, int es) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int row = d * es;
  for (int b = 16; b > es; b /= 2)
    if (row % b == 0 && addr % b == 0) return b;
  return es;
}

}  // namespace

// q (bh, sq, d), k / v (bh, skv, d), out (bh, sq, d); all contiguous, one
// dtype (is_bf16); 1 <= sq <= 16, 1 <= d <= 128; keys at or past kv_end
// are not visited; n_split = ceil(kv_end / 256); part holds
// bh * sq * n_split * (d + 2) floats.
extern "C" int repro_flash_decode(const void* q, const void* k,
                                  const void* v, void* out, void* part,
                                  int is_bf16, int bh, int sq, int skv,
                                  int kv_end, int d, float scale, int causal,
                                  int q_offset, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq < 1 || sq > MAX_SQ || d < 1 || d > THREADS || kv_end < 1 ||
      kv_end > skv || n_split != (kv_end + SPLIT - 1) / SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
#define REPRO_FD_ARGS \
  q, k, v, out, p, bh, sq, skv, kv_end, d, scale, causal, q_offset, n_split, s
  if (is_bf16) {
    switch (load_bytes(q, k, v, d, 2)) {
      case 16: return launch<__nv_bfloat16, 16>(REPRO_FD_ARGS);
      case 8: return launch<__nv_bfloat16, 8>(REPRO_FD_ARGS);
      case 4: return launch<__nv_bfloat16, 4>(REPRO_FD_ARGS);
      default: return launch<__nv_bfloat16, 2>(REPRO_FD_ARGS);
    }
  }
  switch (load_bytes(q, k, v, d, 4)) {
    case 16: return launch<float, 16>(REPRO_FD_ARGS);
    case 8: return launch<float, 8>(REPRO_FD_ARGS);
    default: return launch<float, 4>(REPRO_FD_ARGS);
  }
#undef REPRO_FD_ARGS
}
