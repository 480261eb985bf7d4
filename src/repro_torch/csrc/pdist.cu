// Dense distance matrix, matmul family (sqeuclidean, euclidean, cosine, dot).
//
// Replaces the TPU kernel src/repro/kernels/pdist/pdist.py:_matmul_kernel
// (entry pdist_pallas).  out[i, j] = epilogue(X[i] . Y[j], |X[i]|^2,
// |Y[j]|^2) for X (m, d), Y (n, d), row-major f32.
//
// Bound on an H100: 2*m*n*d flops of f32 FMA against (m + n)*d + m*n words
// of traffic.  At the main-path shape (D on the projection subset, 2048 x
// 2048 x 784) that is 6.6 GFLOP (~98 us at 67 TFLOP/s) against ~30 MB
// (~9 us at 3.35 TB/s): compute-bound on the CUDA cores.  The reference is
// full f32, so the tensor cores (TF32 at best) are not used.
//
// Design: one block of 256 threads per 64 x 64 output tile; tiles of X and
// Y over d (16 wide) pass through shared memory, stored k-major and padded
// so each thread reads its 4 rows and 4 columns as float4; every thread
// keeps a 4 x 4 register tile of the cross term.  Two warps accumulate the
// 64 squared norms of the X tile's rows and two those of the Y tile's rows
// from the same shared tiles, so nothing is read twice from memory.  The
// epilogue (clamp >= 0, sqrt, cosine normalisation, negation) is applied
// to the registers and the tile is written once.  A simple, correct first
// version: register tiles larger than 4 x 4 and a cp.async pipeline would
// raise the FMA share; that is later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps float4 alignment, spreads the k-major stores

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
    if (tid < TM) {
#pragma unroll
      for (int c = 0; c < TK; ++c) norm = fmaf(Xs[c][tid], Xs[c][tid], norm);
    } else if (tid < TM + TN) {
      const int r = tid - TM;
#pragma unroll
      for (int c = 0; c < TK; ++c) norm = fmaf(Ys[c][r], Ys[c][r], norm);
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
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < TM) {
    sx[tid] = norm;
  } else if (tid < TM + TN) {
    sy[tid - TM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc < n) {
        out[(size_t)gr * n + gc] =
            rt::epilogue(metric, acc[i][j], sx[ty * 4 + i], sy[tx * 4 + j]);
      }
    }
  }
}

}  // namespace

extern "C" int pdist_f32(const float* X, const float* Y, float* out, int m,
                         int n, int d, int metric, void* stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  pdist_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      X, Y, out, m, n, d, metric);
  return static_cast<int>(cudaGetLastError());
}
