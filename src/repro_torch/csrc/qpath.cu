// Semiring matrix product over (min, combine): the q-path sweep.
//
// Replaces the TPU kernel src/repro/kernels/qpath/qpath.py:_qpath_kernel
// (entry qpath_matmul_pallas).  C[i, j] = min_k combine(A[i, k], B[k, j])
// for A (m, kd), B (kd, n), row-major f32, with combine chosen at compile
// time: + (minplus), max (minmax, q = inf) or logaddexp (logminplus, finite
// q in the log-power domain).  +inf is the identity of min and pads every
// ragged edge.
//
// Bound on an H100: no tensor-core mapping (min is not a ring sum), so it
// is CUDA-core work.  minmax and minplus cost two f32 instructions per
// (i, j, k) — combine and min — so 2*m*n*kd instructions (2048^3: 17.2 G,
// ~0.51 ms at 33.5 T instructions/s, the 67 TFLOP/s f32 peak counted one
// instruction per lane).  logminplus needs exp and log1p per combine: two
// special-function-unit operations at 16 per SM per clock (4.18 T/s on 132
// SMs at 1.98 GHz), ~4.1 ms at 2048^3 — the SFUs bound it.  Traffic is
// (m*kd + kd*n + m*n) words, ~50 MB at 2048^3: far below either.
//
// Design: one block of 256 threads per 64 x 64 output tile, a 4 x 4 tile
// per thread held in registers and initialised to +inf; A and B slices of
// depth 16 pass through shared memory (A stored k-major) so each thread
// reads its 4 rows and 4 columns as float4.  Out-of-range rows, columns
// and k read +inf.  The mode is a template parameter, so the inner loop has
// no branch.  logaddexp reproduces jnp.logaddexp at +-inf: when a - b is
// NaN (both infinite with the same sign) the result is a + b, which keeps
// (-inf, -inf) -> -inf on the diagonal of the log-domain edge matrix.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;

// Must match repro_torch/kernels/qpath/qpath.py:MODE_CODES.
enum Mode : int { MINPLUS = 0, MINMAX = 1, LOGMINPLUS = 2 };

template <int MODE>
__device__ __forceinline__ float combine(float a, float b) {
  if (MODE == MINPLUS) return a + b;
  if (MODE == MINMAX) return fmaxf(a, b);
  const float delta = a - b;
  return isnan(delta) ? a + b : fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    qpath_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int m, int kd, int n) {
  __shared__ __align__(16) float As[TK][TM + PAD];
  __shared__ __align__(16) float Bs[TK][TN + PAD];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = INFINITY;

  for (int k0 = 0; k0 < kd; k0 += TK) {
    for (int e = tid; e < TM * TK; e += THREADS) {
      const int r = e / TK;
      const int c = e % TK;
      const int gr = row0 + r;
      const int gk = k0 + c;
      As[c][r] = (gr < m && gk < kd) ? A[(size_t)gr * kd + gk] : INFINITY;
    }
    for (int e = tid; e < TK * TN; e += THREADS) {
      const int r = e / TN;
      const int c = e % TN;
      const int gk = k0 + r;
      const int gc = col0 + c;
      Bs[r][c] = (gk < kd && gc < n) ? B[(size_t)gk * n + gc] : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fminf(acc[i][j], combine<MODE>(av[i], bv[j]));
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
      if (gc < n) C[(size_t)gr * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int qpath_f32(const float* A, const float* B, float* C, int m,
                         int kd, int n, int mode, void* stream) {
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MINPLUS:
      qpath_kernel<MINPLUS><<<grid, THREADS, 0, s>>>(A, B, C, m, kd, n);
      break;
    case MINMAX:
      qpath_kernel<MINMAX><<<grid, THREADS, 0, s>>>(A, B, C, m, kd, n);
      break;
    case LOGMINPLUS:
      qpath_kernel<LOGMINPLUS><<<grid, THREADS, 0, s>>>(A, B, C, m, kd, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
