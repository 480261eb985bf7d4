// Shared by the distance kernels (pdist.cu, topk.cu, topk_int8.cu), the
// q-path sweep (qpath.cu) and the embedding bag (bag.cu): metric codes, the
// fused epilogue that turns the f32 cross term and the two squared norms
// into a distance — the arithmetic of kernels/pdist/ref.py and of the TPU
// kernels' epilogues (src/repro/kernels/pdist/pdist.py:_matmul_kernel) —
// the cp.async copies of the tiled kernels and the bag, and the streaming
// top-k selection of the fused scans.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

// Must match repro_torch/kernels/pdist/pdist.py:METRIC_CODES.
enum Metric : int {
  SQEUCLIDEAN = 0,
  EUCLIDEAN = 1,
  COSINE = 2,
  DOT = 3,
  MANHATTAN = 4,
  CHEBYSHEV = 5,
};

// How a distance tile accumulates over d: the matmul family sums x*y (and
// the squared norms) and finishes in `epilogue`; the cube family sums
// |x - y| (manhattan) or takes its max (chebyshev), and the accumulator is
// the distance.  One template instance of each distance kernel per family.
enum Family : int { MATMUL_FAMILY = 0, MANHATTAN_FAMILY = 1, CHEBYSHEV_FAMILY = 2 };

constexpr float EPS = 1e-12f;

__device__ __forceinline__ float epilogue(int metric, float dot, float sx,
                                          float sy) {
  if (metric == DOT) return -dot;
  if (metric == COSINE) {
    const float nx = sqrtf(fmaxf(sx, EPS));
    const float ny = sqrtf(fmaxf(sy, EPS));
    return 1.0f - dot / (nx * ny);
  }
  const float d2 = fmaxf(sx + sy - 2.0f * dot, 0.0f);
  return metric == EUCLIDEAN ? sqrtf(d2) : d2;
}

// One step of a distance accumulation for family FAM.
template <int FAM>
__device__ __forceinline__ float accumulate(float acc, float x, float y) {
  if constexpr (FAM == MATMUL_FAMILY) {
    return fmaf(x, y, acc);
  } else if constexpr (FAM == MANHATTAN_FAMILY) {
    return acc + fabsf(x - y);
  } else {
    return fmaxf(acc, fabsf(x - y));
  }
}

// ---------------------------------------------------------------------------
// global -> shared copies by cp.async (topk.cu, pdist.cu, qpath.cu, bag.cu)
// ---------------------------------------------------------------------------

// 16 bytes, or 16 zero bytes when !full (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0));
}

// One float, or 0 when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) x columns [k0, k0 + BK) of the row-major A (rows x ld)
// into dst (R x LDS floats), zero past `rows` and past column kend, by the
// THREADS threads of a block.  VEC: 16-byte chunks (ld and kend multiples
// of 4, A 16-byte aligned, LDS a multiple of 4); else one float each.
template <int R, int BK, int LDS, int THREADS, bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* A, int r0, int rows,
                                          int k0, int kend, int ld, int tid) {
  if constexpr (VEC) {
    constexpr int CH = BK / 4;
#pragma unroll
    for (int e = tid; e < R * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e % CH) * 4;
      const bool ok = r0 + r < rows && k0 + c < kend;
      cp_async16(dst + r * LDS + c, ok ? A + (size_t)(r0 + r) * ld + k0 + c : A, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < R * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const bool ok = r0 + r < rows && k0 + c < kend;
      cp_async4(dst + r * LDS + c, ok ? A + (size_t)(r0 + r) * ld + k0 + c : A, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// streaming top-k selection (topk.cu, topk_int8.cu)
//
// A running top-k list is sorted ascending by (distance, column): an entry
// goes after every entry with a smaller distance, or an equal distance and
// a lower column.  Comparing pairs makes the lists independent of the
// order in which candidates arrive, so lax.top_k's lowest-index tie rule
// holds however a scan visits its columns, and lists of disjoint column
// ranges merge by the same order (topk_merge).  +inf is never inserted, so
// slots past the valid candidates keep (+inf, -1); a finite candidate
// sorts before such a slot.
// ---------------------------------------------------------------------------

// Largest k whose running lists sit in shared memory: rows * k * 8 bytes
// of dynamic shared memory (128 KB for 32 rows at k = 512), opted in with
// cudaFuncSetAttribute.  Above it the int8 scan keeps its lists in global
// memory (its GLOBAL_LISTS instance), merged by the whole warp
// (warp_insert_sorted): one lane shifting k entries through L1/L2 one at a
// time, as the shared lists are, made a 512 x 60000 x 784 scan at k = 600
// take 485-619 ms on an H100 (NVIDIA H100 80GB HBM3, 700 W) against 6.3 ms
// for the plain version.  The f32 scan instead writes its distances out
// and selects the k smallest of each row by radix (topk.cu).
constexpr int SEL_SMEM_MAX_K = 512;
// Most column splits of one scan: topk_merge holds one list head per lane.
// Must match kernels/topk/topk.py:MAX_SPLITS.
constexpr int MAX_SPLITS = 32;

// (v, c) before (w, e) in a list's order.
__device__ __forceinline__ bool before(float v, int c, float w, int e) {
  return v < w || (v == w && c < e);
}

__device__ __forceinline__ void insert_sorted(float* bd, int* bi, int k, float v, int col) {
  if (!before(v, col, bd[k - 1], bi[k - 1])) return;
  int p = k - 1;
  while (p > 0 && before(v, col, bd[p - 1], bi[p - 1])) {
    bd[p] = bd[p - 1];
    bi[p] = bi[p - 1];
    --p;
  }
  bd[p] = v;
  bi[p] = col;
}

// insert_sorted for a list in global memory, by all 32 lanes of a warp
// (called with warp-uniform arguments): the position is the count of
// entries before (v, col), summed over the lanes' strided slices; the tail
// then moves up one slot 32 entries at a time, top chunk first, each chunk
// read before it is written.
__device__ __forceinline__ void warp_insert_sorted(float* bd, int* bi, int k,
                                                   float v, int col,
                                                   int lane) {
  if (!before(v, col, bd[k - 1], bi[k - 1])) return;
  int p = 0;
  for (int e = lane; e < k; e += 32) {
    if (before(bd[e], bi[e], v, col)) ++p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
  for (int top = k - 1; top > p; top -= 32) {
    const int dst = top - lane;
    const bool moves = dst > p;
    float dv = 0.0f;
    int di = 0;
    if (moves) {
      dv = bd[dst - 1];
      di = bi[dst - 1];
    }
    __syncwarp();
    if (moves) {
      bd[dst] = dv;
      bi[dst] = di;
    }
    __syncwarp();
  }
  if (lane == 0) {
    bd[p] = v;
    bi[p] = col;
  }
  __syncwarp();
}

}  // namespace rt

// |a|^2 of every row of X (m, d) then Y (n, d) into norms (m + n), on
// `stream`; defined in topk.cu, the pre-pass of the matmul family in
// topk_f32 and pdist_f32.
extern "C" int sqnorms(const float* X, const float* Y, float* norms, int m, int n, int d,
                       void* stream);

// The k smallest by (distance, column) of each row's `splits` sorted lists
// (part (m, splits, k) -> out (m, k)), on `stream`; defined in topk.cu,
// run by both scans after their column splits.
extern "C" int topk_merge(const float* part_d, const int* part_i, float* out_d, int* out_i,
                          int m, int splits, int k, void* stream);
