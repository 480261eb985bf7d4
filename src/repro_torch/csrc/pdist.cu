// Dense distance matrix: the matmul family (sqeuclidean, euclidean,
// cosine, dot) and the cube family (manhattan, chebyshev).
//
// Replaces the TPU kernels src/repro/kernels/pdist/pdist.py:_matmul_kernel
// and :_cube_kernel (entry pdist_pallas).  For X (m, d), Y (n, d),
// row-major f32: out[i, j] = epilogue(X[i] . Y[j], |X[i]|^2, |Y[j]|^2) in
// the matmul family, sum_l |X[i, l] - Y[j, l]| (manhattan) or
// max_l |X[i, l] - Y[j, l]| (chebyshev) in the cube family.
//
// Bound on an H100: the matmul family does 2*m*n*d flops of f32 FMA
// against (m + n)*d + m*n words of traffic.  At the main-path shape (D on
// the projection subset, 2048 x 2048 x 784) that is 6.6 GFLOP (~98 us at
// 67 TFLOP/s) against ~30 MB (~9 us at 3.35 TB/s): compute-bound on the
// CUDA cores.  The reference is full f32, so the tensor cores (TF32 at
// best) are not used.  The cube family does two f32 instructions per
// (i, j, l) (subtract, then add or max with the absolute value as an
// operand modifier): ~0.196 ms at 33.5 T instructions/s for 2048^2 x 784.
//
// Design: one block of 256 threads per 64 x 64 output tile; tiles of X and
// Y over d (16 wide) pass through shared memory, stored k-major and padded
// so each thread reads its 4 rows and 4 columns as float4; every thread
// keeps a 4 x 4 register tile.  The family is a template parameter (the
// step is common.cuh:accumulate): the matmul instance also has two warps
// accumulate the 64 squared norms of the X tile's rows and two those of
// the Y tile's rows from the same shared tiles, and applies the epilogue
// (clamp >= 0, sqrt, cosine normalisation, negation) to the registers; the
// cube instances start from 0 and write the accumulator (zero-padded d
// columns add |0 - 0| = 0).  The tile is written once.  A simple, correct
// first version: register tiles larger than 4 x 4 and a cp.async pipeline
// would raise the arithmetic share; that is later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps float4 alignment, spreads the k-major stores

template <int FAM>
__global__ void __launch_bounds__(THREADS)
    pdist_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 float* __restrict__ out, int m, int n, int d, int metric) {
  __shared__ __align__(16) float Xs[TK][TM + PAD];
  __shared__ __align__(16) float Ys[TK][TN + PAD];
  __shared__ float sx[TM];
  __shared__ float sy[TN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int ty = tid / 16;  // output rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // output cols tx*4 .. tx*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float norm = 0.0f;  // threads [0, 64): X rows; [64, 128): Y rows

  for (int k0 = 0; k0 < d; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int r = e / TK;
      const int c = e % TK;
      const int gk = k0 + c;
      const int gx = row0 + r;
      const int gy = col0 + r;
      Xs[c][r] = (gx < m && gk < d) ? X[(size_t)gx * d + gk] : 0.0f;
      Ys[c][r] = (gy < n && gk < d) ? Y[(size_t)gy * d + gk] : 0.0f;
    }
    __syncthreads();
    if constexpr (FAM == rt::MATMUL_FAMILY) {
      if (tid < TM) {
#pragma unroll
        for (int c = 0; c < TK; ++c) norm = fmaf(Xs[c][tid], Xs[c][tid], norm);
      } else if (tid < TM + TN) {
        const int r = tid - TM;
#pragma unroll
        for (int c = 0; c < TK; ++c) norm = fmaf(Ys[c][r], Ys[c][r], norm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ys[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = rt::accumulate<FAM>(acc[i][j], av[i], bv[j]);
    }
    __syncthreads();
  }
  if constexpr (FAM == rt::MATMUL_FAMILY) {
    if (tid < TM) {
      sx[tid] = norm;
    } else if (tid < TM + TN) {
      sy[tid - TM] = norm;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < n) {
        float v = acc[i][j];
        if constexpr (FAM == rt::MATMUL_FAMILY) {
          v = rt::epilogue(metric, v, sx[ty * 4 + i], sy[tx * 4 + j]);
        }
        out[(size_t)gr * n + gc] = v;
      }
    }
  }
}

}  // namespace

extern "C" int pdist_f32(const float* X, const float* Y, float* out, int m,
                         int n, int d, int metric, void* stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case rt::SQEUCLIDEAN:
    case rt::EUCLIDEAN:
    case rt::COSINE:
    case rt::DOT:
      pdist_kernel<rt::MATMUL_FAMILY><<<grid, THREADS, 0, s>>>(X, Y, out, m, n,
                                                              d, metric);
      break;
    case rt::MANHATTAN:
      pdist_kernel<rt::MANHATTAN_FAMILY><<<grid, THREADS, 0, s>>>(X, Y, out, m,
                                                                 n, d, metric);
      break;
    case rt::CHEBYSHEV:
      pdist_kernel<rt::CHEBYSHEV_FAMILY><<<grid, THREADS, 0, s>>>(X, Y, out, m,
                                                                 n, d, metric);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
