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
// Design.  A call is two kernels: the squared norms of every row of X and
// Y (matmul family only: topk.cu's pre-pass, C entry sqnorms) and the
// tile kernel.  The first design (one 64 x 64 tile per block, 4 x 4
// register tiles fed by two float4 shared reads per 16 FMAs, slices stored
// element by element behind two barriers each, norms summed by 128 threads
// inside every slice) fed the FMAs from shared memory at about half their
// rate: 0.2764 ms at 2048 x 2048 x 784, 1.32x torch.cdist, and 0.3590 /
// 0.3741 ms for manhattan / chebyshev (NVIDIA H100 80GB HBM3, 700 W).
//
// - Tiles: one block of 256 threads (8 warps) per 128 x 64 output tile,
//   two blocks per SM (512 tiles at 2048^2).  The warps form a 4 x 2 grid
//   of 32 x 32 warp tiles; a lane owns rows r + 4 i (i < 8) and columns
//   c + 8 j (j < 4) of its warp tile, an 8 x 4 register tile.  Per 4 steps
//   of d a thread reads 8 float4 of X (each shared by the 8 lanes of a
//   quarter-warp) and 4 float4 of Y for 128 FMAs: 2.7 FMAs per float
//   read, where 4 x 4 tiles fed 2.  128 x 128 tiles with 8 x 8 register
//   tiles (4 FMAs per float read) read slower on the card, the matmul and
//   cube instances alike: at two blocks per SM they sit at the 128-register
//   cap, and at one they leave the second wave of 2048^2 half empty.
// - Copies: X and Y slices of 32 d-values pass global -> shared by
//   cp.async (common.cuh:load_rows: 16-byte chunks where d % 4 == 0 and the
//   rows are aligned, 4-byte elements otherwise; zero past m, n and d,
//   which adds nothing in either family) in a ring of 3 stages, one barrier
//   per stage.  Shared rows are d-major with a stride of 36 floats, so the
//   float4 reads of a quarter-warp's 8 rows fall on distinct banks.
// - Epilogue: rt::epilogue on the registers, with the norms read from the
//   pre-pass's buffer; a warp's store covers 4 rows x 8 consecutive
//   columns, whole 32-byte sectors.
// - The cube instances run the same engine (the step is
//   common.cuh:accumulate); chebyshev is a max of exact differences, so any
//   order is bit-identical to the plain version.
//
// Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, D on the
// 2048 x 784 projection subset): euclidean 0.2012 ms (torch.cdist 0.2150,
// bound 0.098), manhattan 0.2971 ms, chebyshev 0.2938 ms (bound 0.196).
// PERF.md has every row.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128;          // rows of X per block
constexpr int BN = 64;           // rows of Y per block
constexpr int TM = 8;            // rows per thread: r + 4 i
constexpr int TN = BN / 16;      // columns per thread: c + 8 j (4)
constexpr int BK = 32;           // d per pipeline stage
constexpr int LDS = BK + 4;      // shared row stride, floats
constexpr int STAGES = 3;
constexpr size_t SMEM_BYTES = sizeof(float) * STAGES * (BM + BN) * LDS;

template <int FAM, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    pdist_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                 const float* __restrict__ norms, float* __restrict__ out, int m, int n,
                 int d, int metric) {
  extern __shared__ __align__(16) float smem[];
  float* xs_ring = smem;                         // [STAGES][BM][LDS]
  float* ys_ring = xs_ring + STAGES * BM * LDS;  // [STAGES][BN][LDS]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tr = (warp / 2) * 32 + lane / 8;  // rows tr + 4 i of the tile
  const int tc = (warp % 2) * (BN / 2) + lane % 8;  // columns tc + 8 j
  const int nk = (d + BK - 1) / BK;

  auto load_stage = [&](int g) {
    const int slot = g % STAGES;
    rt::load_rows<BM, BK, LDS, THREADS, VEC>(xs_ring + slot * BM * LDS, X, row0, m, g * BK,
                                             d, d, tid);
    rt::load_rows<BN, BK, LDS, THREADS, VEC>(ys_ring + slot * BN * LDS, Y, col0, n, g * BK,
                                             d, d, tid);
  };

#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < nk) load_stage(g);
    rt::cp_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < nk; ++g) {
    rt::cp_wait<STAGES - 2>();
    __syncthreads();  // stage g landed; every warp is done with stage g - 1
    if (g + STAGES - 1 < nk) load_stage(g + STAGES - 1);
    rt::cp_commit();

    const float* xs = xs_ring + (g % STAGES) * BM * LDS + tr * LDS;
    const float* ys = ys_ring + (g % STAGES) * BN * LDS + tc * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(ys + 8 * j * LDS + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + 4 * i * LDS + kk);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v = acc[i][j];
          v = rt::accumulate<FAM>(v, a.x, b[j].x);
          v = rt::accumulate<FAM>(v, a.y, b[j].y);
          v = rt::accumulate<FAM>(v, a.z, b[j].z);
          acc[i][j] = rt::accumulate<FAM>(v, a.w, b[j].w);
        }
      }
    }
  }
  rt::cp_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr + 4 * i;
    if (gr >= m) break;
    const float xn = FAM == rt::MATMUL_FAMILY ? norms[gr] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tc + 8 * j;
      if (gc < n) {
        float v = acc[i][j];
        if constexpr (FAM == rt::MATMUL_FAMILY) v = rt::epilogue(metric, v, xn, norms[m + gc]);
        out[(size_t)gr * n + gc] = v;
      }
    }
  }
}

template <int FAM, bool VEC>
int launch(const float* X, const float* Y, const float* norms, float* out, int m, int n,
           int d, int metric, cudaStream_t s) {
  auto kernel = pdist_kernel<FAM, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, s>>>(X, Y, norms, out, m, n, d, metric);
  return static_cast<int>(cudaGetLastError());
}

template <int FAM>
int launch_family(const float* X, const float* Y, const float* norms, float* out, int m,
                  int n, int d, int metric, bool vec, cudaStream_t s) {
  return vec ? launch<FAM, true>(X, Y, norms, out, m, n, d, metric, s)
             : launch<FAM, false>(X, Y, norms, out, m, n, d, metric, s);
}

}  // namespace

// norms: (m + n) f32 scratch for the matmul family (null for the cube
// family).  aligned: d % 4 == 0 and X, Y 16-byte aligned.
extern "C" int pdist_f32(const float* X, const float* Y, float* out, float* norms, int m,
                         int n, int d, int metric, int aligned, void* stream) {
  if (m < 1 || n < 1 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned != 0;
  switch (metric) {
    case rt::SQEUCLIDEAN:
    case rt::EUCLIDEAN:
    case rt::COSINE:
    case rt::DOT: {
      if (norms == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const int err = sqnorms(X, Y, norms, m, n, d, stream);
      if (err != 0) return err;
      return launch_family<rt::MATMUL_FAMILY>(X, Y, norms, out, m, n, d, metric, vec, s);
    }
    case rt::MANHATTAN:
      return launch_family<rt::MANHATTAN_FAMILY>(X, Y, nullptr, out, m, n, d, metric, vec, s);
    case rt::CHEBYSHEV:
      return launch_family<rt::CHEBYSHEV_FAMILY>(X, Y, nullptr, out, m, n, d, metric, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
