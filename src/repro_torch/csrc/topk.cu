// Fused distance + streaming top-k over f32 rows: the matmul family
// (sqeuclidean, euclidean, cosine, dot) and the cube family (manhattan,
// chebyshev).
//
// Replaces the TPU kernels src/repro/kernels/topk/topk.py:_matmul_kernel
// and :_cube_kernel (entry topk_pallas; helpers _mask_tile,
// _select_and_store, _merge_topk).  For every row of X (m, d) it returns
// the k nearest rows of Y (n, d): distances (m, k) ascending and their
// column ids (m, k) int32, without writing the (m, n) distance matrix.
// Masks: columns >= n, columns whose `valid` byte is 0, and the global
// diagonal when exclude_self is set.  Ties go to the lowest column; slots
// past the valid candidates hold (+inf, -1).
//
// Bound on an H100: the matmul family does 2*m*n*d f32 flops (one FMA per
// (i, j, l)) against (m + n)*d + 2*m*k words: compute-bound on the CUDA
// cores (kNN graph 2048 x 2048 x 784: ~98 us; ground truth 10000 x 60000 x
// 784: 0.94 TFLOP, ~14 ms at 67 TFLOP/s).  The cube family does two f32
// instructions per (i, j, l) (a subtraction, then an add or max that takes
// the absolute value as an operand modifier) and has no tensor-core form:
// ~0.196 ms for the kNN graph, ~28 ms for the ground truth at 33.5 T
// instructions/s.
//
// Design: one block of 256 threads owns a strip of 32 query rows and
// streams Y in tiles of 64 columns.  X and Y slices over d pass through
// shared memory, stored d-major, and every thread keeps a 2 x 4 register
// tile.  The distance family is a template parameter: the matmul instance
// accumulates the cross term and (three warps, from the same shared tiles)
// the squared norms, then applies the epilogue; the cube instances
// accumulate |x - y| by sum or max, starting from 0, and the accumulator
// is the distance (zero-padded d columns add |0 - 0| = 0).  The finished
// tile is staged in shared memory with the masks applied and merged into
// the running top-k by the ballot insert that common.cuh describes, in
// shared memory up to k = 512 and in the output buffers above it.  Known
// limit of this first version: at m = 2048 the 32-row strips give 64
// blocks for 132 SMs, so the kNN-graph call leaves half the card idle, and
// a 512-query brute batch (16 blocks) leaves most of it idle.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = rt::SEL_ROWS;
constexpr int BN = rt::SEL_COLS;
constexpr int BK = 16;
constexpr int THREADS = rt::SEL_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;

// GLOBAL_LISTS (k > SEL_SMEM_MAX_K): the running lists are this strip's
// rows of out_d / out_i, merged by the whole warp (warp_insert_sorted);
// nothing is copied out at the end.
template <int FAM, bool GLOBAL_LISTS>
__global__ void __launch_bounds__(THREADS)
    topk_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const unsigned char* __restrict__ valid,
                float* __restrict__ out_d, int* __restrict__ out_i, int m,
                int n, int d, int k, int metric, int exclude_self) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* best_d;  // [BM][k]
  int* best_i;    // [BM][k]
  if constexpr (GLOBAL_LISTS) {
    best_d = out_d + (size_t)blockIdx.x * BM * k;
    best_i = out_i + (size_t)blockIdx.x * BM * k;
  } else {
    best_d = reinterpret_cast<float*>(smem_raw);
    best_i = reinterpret_cast<int*>(best_d + BM * k);
  }
  __shared__ __align__(16) float Xs[BK][BM + PAD];
  __shared__ __align__(16) float Ys[BK][BN + PAD];
  __shared__ float Dt[BM][BN + 1];
  __shared__ float sx[BM];
  __shared__ float sy[BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = tid / 16;  // rows ty*2, ty*2+1
  const int tx = tid % 16;  // cols tx*4 .. tx*4+3

  if constexpr (GLOBAL_LISTS) {
    const size_t owned = (size_t)min(BM, m - row0) * k;  // rows inside X
    for (size_t e = tid; e < owned; e += THREADS) {
      best_d[e] = INFINITY;
      best_i[e] = -1;
    }
  } else {
    for (int e = tid; e < BM * k; e += THREADS) {
      best_d[e] = INFINITY;
      best_i[e] = -1;
    }
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float norm = 0.0f;  // threads [0, 64): Y rows; [64, 96): X rows

    for (int k0 = 0; k0 < d; k0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK;
        const int c = e % BK;
        const int gr = row0 + r;
        const int gk = k0 + c;
        Xs[c][r] = (gr < m && gk < d) ? X[(size_t)gr * d + gk] : 0.0f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK;
        const int c = e % BK;
        const int gr = col0 + r;
        const int gk = k0 + c;
        Ys[c][r] = (gr < n && gk < d) ? Y[(size_t)gr * d + gk] : 0.0f;
      }
      __syncthreads();
      if constexpr (FAM == rt::MATMUL_FAMILY) {
        if (tid < BN) {
#pragma unroll
          for (int c = 0; c < BK; ++c) norm = fmaf(Ys[c][tid], Ys[c][tid], norm);
        } else if (tid < BN + BM) {
          const int r = tid - BN;
#pragma unroll
          for (int c = 0; c < BK; ++c) norm = fmaf(Xs[c][r], Xs[c][r], norm);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float2 a = *reinterpret_cast<const float2*>(&Xs[kk][ty * 2]);
        const float4 b = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
        const float av[2] = {a.x, a.y};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = rt::accumulate<FAM>(acc[i][j], av[i], bv[j]);
      }
      __syncthreads();
    }
    if constexpr (FAM == rt::MATMUL_FAMILY) {
      if (tid < BN) {
        sy[tid] = norm;
      } else if (tid < BN + BM) {
        sx[tid - BN] = norm;
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const int gr = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int gc = col0 + c;
        float v = acc[i][j];
        if constexpr (FAM == rt::MATMUL_FAMILY) {
          v = rt::epilogue(metric, v, sx[r], sy[c]);
        }
        if (gc >= n || (valid != nullptr && valid[gc] == 0) ||
            (exclude_self && gr == gc)) {
          v = INFINITY;
        }
        Dt[r][c] = v;
      }
    }
    __syncthreads();
    for (int r = warp; r < BM; r += WARPS) {
      if (row0 + r >= m) continue;  // uniform across the warp
      float* bd = best_d + (size_t)r * k;
      int* bi = best_i + (size_t)r * k;
      const float thr = bd[k - 1];
      const unsigned lo = __ballot_sync(0xffffffffu, Dt[r][lane] < thr);
      const unsigned hi = __ballot_sync(0xffffffffu, Dt[r][lane + 32] < thr);
      if constexpr (GLOBAL_LISTS) {
        for (unsigned bits = lo; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          rt::warp_insert_sorted(bd, bi, k, Dt[r][b], col0 + b, lane);
        }
        for (unsigned bits = hi; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          rt::warp_insert_sorted(bd, bi, k, Dt[r][32 + b], col0 + 32 + b, lane);
        }
      } else if (lane == 0) {
        for (unsigned bits = lo; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          rt::insert_sorted(bd, bi, k, Dt[r][b], col0 + b);
        }
        for (unsigned bits = hi; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          rt::insert_sorted(bd, bi, k, Dt[r][32 + b], col0 + 32 + b);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  if constexpr (!GLOBAL_LISTS) {
    for (int e = tid; e < BM * k; e += THREADS) {
      const int gr = row0 + e / k;
      if (gr < m) {
        out_d[(size_t)row0 * k + e] = best_d[e];
        out_i[(size_t)row0 * k + e] = best_i[e];
      }
    }
  }
}

template <int FAM, bool GLOBAL_LISTS>
int launch_lists(const float* X, const float* Y, const unsigned char* valid,
                 float* out_d, int* out_i, int m, int n, int d, int k,
                 int metric, int exclude_self, cudaStream_t stream) {
  size_t smem = 0;  // the GLOBAL_LISTS instance keeps no lists here
  if constexpr (!GLOBAL_LISTS) {
    const cudaError_t err =
        rt::reserve_best_smem(topk_kernel<FAM, false>, k, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((m + BM - 1) / BM);
  topk_kernel<FAM, GLOBAL_LISTS><<<grid, THREADS, smem, stream>>>(
      X, Y, valid, out_d, out_i, m, n, d, k, metric, exclude_self);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM>
int launch(const float* X, const float* Y, const unsigned char* valid,
           float* out_d, int* out_i, int m, int n, int d, int k, int metric,
           int exclude_self, cudaStream_t stream) {
  if (k <= rt::SEL_SMEM_MAX_K) {
    return launch_lists<FAM, false>(X, Y, valid, out_d, out_i, m, n, d, k,
                                    metric, exclude_self, stream);
  }
  return launch_lists<FAM, true>(X, Y, valid, out_d, out_i, m, n, d, k,
                                 metric, exclude_self, stream);
}

}  // namespace

extern "C" int topk_f32(const float* X, const float* Y,
                        const unsigned char* valid, float* out_d, int* out_i,
                        int m, int n, int d, int k, int metric,
                        int exclude_self, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case rt::SQEUCLIDEAN:
    case rt::EUCLIDEAN:
    case rt::COSINE:
    case rt::DOT:
      return launch<rt::MATMUL_FAMILY>(X, Y, valid, out_d, out_i, m, n, d, k,
                                       metric, exclude_self, s);
    case rt::MANHATTAN:
      return launch<rt::MANHATTAN_FAMILY>(X, Y, valid, out_d, out_i, m, n, d,
                                          k, metric, exclude_self, s);
    case rt::CHEBYSHEV:
      return launch<rt::CHEBYSHEV_FAMILY>(X, Y, valid, out_d, out_i, m, n, d,
                                          k, metric, exclude_self, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
