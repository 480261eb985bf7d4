// Fused distance + streaming top-k, f32 matmul family (sqeuclidean,
// euclidean, cosine, dot).
//
// Replaces the TPU kernel src/repro/kernels/topk/topk.py:_matmul_kernel
// (entry topk_pallas; helpers _mask_tile, _select_and_store, _merge_topk).
// For every row of X (m, d) it returns the k nearest rows of Y (n, d):
// distances (m, k) ascending and their column ids (m, k) int32, without
// writing the (m, n) distance matrix.  Masks: columns >= n, columns whose
// `valid` byte is 0, and the global diagonal when exclude_self is set.
// Ties go to the lowest column; slots past the valid candidates hold
// (+inf, -1).
//
// Bound on an H100: the same 2*m*n*d f32 FMA flops as pdist against
// (m + n)*d + 2*m*k words: compute-bound on the CUDA cores (kNN graph
// 2048 x 2048 x 784: ~98 us; ground truth 10000 x 60000 x 784: 0.94 TFLOP,
// ~14 ms at 67 TFLOP/s).
//
// Design: one block of 256 threads owns a strip of 32 query rows and
// streams Y in tiles of 64 columns.  Each tile's distances are computed
// with pdist's arithmetic (X and Y slices over d through shared memory, a
// 2 x 4 register tile per thread, squared norms summed by three warps from
// the same shared tiles) and staged in shared memory with the masks
// applied.  The running top-k of each row lives in shared memory (sorted,
// 32 x k entries).  One warp merges one row at a time: a ballot finds the
// tile's candidates strictly below the row's current k-th distance — for a
// converged row usually none, so the tile costs two shared loads per lane —
// and lane 0 inserts those in ascending column order, each only if still
// strictly below the k-th.  Inserting after equal entries and visiting
// columns in ascending order reproduces lax.top_k's lowest-index tie rule.
// Known limit of this first version: at m = 2048 the 32-row strips give 64
// blocks for 132 SMs, so the kNN-graph call leaves half the card idle.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;
constexpr int MAX_K = 128;

__device__ __forceinline__ void insert_sorted(float* bd, int* bi, int k,
                                              float v, int col) {
  if (!(v < bd[k - 1])) return;
  int p = k - 1;
  while (p > 0 && bd[p - 1] > v) {
    bd[p] = bd[p - 1];
    bi[p] = bi[p - 1];
    --p;
  }
  bd[p] = v;
  bi[p] = col;
}

__global__ void __launch_bounds__(THREADS)
    topk_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const unsigned char* __restrict__ valid,
                float* __restrict__ out_d, int* __restrict__ out_i, int m,
                int n, int d, int k, int metric, int exclude_self) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* best_d = reinterpret_cast<float*>(smem_raw);  // [BM][k]
  int* best_i = reinterpret_cast<int*>(best_d + BM * k);  // [BM][k]
  __shared__ __align__(16) float Xs[BK][BM + PAD];
  __shared__ __align__(16) float Ys[BK][BN + PAD];
  __shared__ float Dt[BM][BN + 1];
  __shared__ float sx[BM];
  __shared__ float sy[BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * BM;
  const int ty = tid / 16;  // rows ty*2, ty*2+1
  const int tx = tid % 16;  // cols tx*4 .. tx*4+3

  for (int e = tid; e < BM * k; e += THREADS) {
    best_d[e] = INFINITY;
    best_i[e] = -1;
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
      if (tid < BN) {
#pragma unroll
        for (int c = 0; c < BK; ++c) norm = fmaf(Ys[c][tid], Ys[c][tid], norm);
      } else if (tid < BN + BM) {
        const int r = tid - BN;
#pragma unroll
        for (int c = 0; c < BK; ++c) norm = fmaf(Xs[c][r], Xs[c][r], norm);
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
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < BN) {
      sy[tid] = norm;
    } else if (tid < BN + BM) {
      sx[tid - BN] = norm;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const int gr = row0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int gc = col0 + c;
        float v = rt::epilogue(metric, acc[i][j], sx[r], sy[c]);
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
      float* bd = best_d + r * k;
      int* bi = best_i + r * k;
      const float thr = bd[k - 1];
      const unsigned lo = __ballot_sync(0xffffffffu, Dt[r][lane] < thr);
      const unsigned hi = __ballot_sync(0xffffffffu, Dt[r][lane + 32] < thr);
      if (lane == 0) {
        for (unsigned bits = lo; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          insert_sorted(bd, bi, k, Dt[r][b], col0 + b);
        }
        for (unsigned bits = hi; bits; bits &= bits - 1) {
          const int b = __ffs(bits) - 1;
          insert_sorted(bd, bi, k, Dt[r][32 + b], col0 + 32 + b);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int e = tid; e < BM * k; e += THREADS) {
    const int gr = row0 + e / k;
    if (gr < m) {
      out_d[(size_t)row0 * k + e] = best_d[e];
      out_i[(size_t)row0 * k + e] = best_i[e];
    }
  }
}

}  // namespace

extern "C" int topk_f32(const float* X, const float* Y,
                        const unsigned char* valid, float* out_d, int* out_i,
                        int m, int n, int d, int k, int metric,
                        int exclude_self, void* stream) {
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(BM) * k * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + BM - 1) / BM);
  topk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      X, Y, valid, out_d, out_i, m, n, d, k, metric, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
