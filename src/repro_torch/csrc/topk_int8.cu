// Fused int8 corpus scan + streaming top-k (sqeuclidean, euclidean).
//
// Replaces the TPU kernel src/repro/kernels/topk/topk.py:_int8_kernel
// (entry topk_quant_pallas).  The query side arrives prepared as the JAX
// entry prepares it outside its kernel (topk.py:404-408): xq (m, d) int8,
// the scale-folded query row-quantised under its own absmax alpha (m,);
// xn (m,) its squared f32 norm.  The corpus is codes (n, d) int8 with
// sqnorms (n,) = |dec(c)|^2.  For every query row the kernel returns the k
// smallest
//     d2 = max(xn + sqnorms - 2 * alpha * (xq . c), 0)    (sqrt: euclidean)
// with their column ids, ascending, ties to the lowest column, (+inf, -1)
// past the valid candidates; `valid` bytes of 0 mask columns out.
//
// Exactness: the cross term accumulates in int32 by __dp4a, which is exact
// (|acc| <= 127^2 * d), and is converted to f32 once, rounded to nearest;
// the epilogue is written with the _rn intrinsics so nvcc cannot contract
// it into an FMA, in the plain version's order: (xn + sqnorms) - 2 * cross.
//
// Bound on an H100: 2*m*n*d int8 operations.  Against the dense int8
// tensor-core peak (1979 TOPS) a 512-query serve batch over 60000 x 784
// is 0.024 ms, the 10000-query set 0.475 ms; the bytes (codes read once,
// n*d) are far below the operations.  This first version runs on the CUDA
// cores (__dp4a, 4 multiply-adds per instruction), not on the tensor
// cores: s8 MMA (mma.sync ...s32.s8.s8.s32 or wgmma) is later work.
//
// Design: the same strip and tile as topk.cu.  One block of 256 threads
// owns 32 query rows and streams the codes in tiles of 64 columns; d
// passes in slices of 64 bytes, staged in shared memory as 16 packed int32
// words per row, d-major, so a thread reads its 2 rows as one int2 and its
// 4 columns as one int4 and issues 8 __dp4a per word.  The finished tile
// gets the epilogue and masks and is merged into the running top-k by the
// ballot insert that common.cuh describes, in shared memory up to k = 512
// and in the output buffers above it.  Known limit of this first
// version: a 512-query serve batch is 16 strips, so 16 of the 132 SMs
// work; splitting the columns over more blocks (then merging their lists)
// is later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int BM = rt::SEL_ROWS;
constexpr int BN = rt::SEL_COLS;
constexpr int BKW = 16;  // int32 words (4 int8 each) per d-slice
constexpr int THREADS = rt::SEL_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;

// Four consecutive int8 of row `row` starting at column gk (a multiple of
// 4), packed little-endian into one int32 (byte b at bits 8b..8b+7, the
// order __dp4a pairs them in); zero past the row or the matrix.  With
// `aligned` (d % 4 == 0 and both base pointers on a word, checked by the
// wrapper) the word is one 4-byte load.
__device__ __forceinline__ int load_word(const signed char* __restrict__ p,
                                         int row, int rows, int d, int gk,
                                         bool aligned) {
  if (row >= rows || gk >= d) return 0;
  const signed char* q = p + (size_t)row * d + gk;
  if (aligned) return *reinterpret_cast<const int*>(q);
  int w = 0;
  for (int b = 0; b < 4 && gk + b < d; ++b) {
    w |= static_cast<int>(static_cast<unsigned char>(q[b])) << (8 * b);
  }
  return w;
}

// GLOBAL_LISTS (k > SEL_SMEM_MAX_K): the running lists are this strip's
// rows of out_d / out_i, merged by the whole warp (warp_insert_sorted);
// nothing is copied out at the end.
template <bool GLOBAL_LISTS>
__global__ void __launch_bounds__(THREADS)
    topk_int8_kernel(const signed char* __restrict__ xq,
                     const signed char* __restrict__ codes,
                     const float* __restrict__ alpha,
                     const float* __restrict__ xn,
                     const float* __restrict__ sqnorms,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int m, int n, int d, int k, int euclidean,
                     int aligned) {
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
  __shared__ __align__(16) int Xw[BKW][BM + PAD];
  __shared__ __align__(16) int Yw[BKW][BN + PAD];
  __shared__ float Dt[BM][BN + 1];
  __shared__ float sa[BM];
  __shared__ float sxn[BM];
  __shared__ float sy[BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ty = tid / 16;  // rows ty*2, ty*2+1
  const int tx = tid % 16;  // cols tx*4 .. tx*4+3
  if constexpr (GLOBAL_LISTS) {
    const size_t owned = (size_t)min(BM, m - row0) * k;  // rows inside xq
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
  if (tid < BM) {
    const int gr = row0 + tid;
    sa[tid] = gr < m ? alpha[gr] : 1.0f;
    sxn[tid] = gr < m ? xn[gr] : 0.0f;
  }

  for (int col0 = 0; col0 < n; col0 += BN) {
    int acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    if (tid < BN) {
      const int gc = col0 + tid;
      sy[tid] = gc < n ? sqnorms[gc] : 0.0f;
    }

    for (int k0 = 0; k0 < d; k0 += 4 * BKW) {
      for (int e = tid; e < BM * BKW; e += THREADS) {
        const int r = e / BKW;
        const int w = e % BKW;
        Xw[w][r] = load_word(xq, row0 + r, m, d, k0 + 4 * w, aligned);
      }
      for (int e = tid; e < BN * BKW; e += THREADS) {
        const int r = e / BKW;
        const int w = e % BKW;
        Yw[w][r] = load_word(codes, col0 + r, n, d, k0 + 4 * w, aligned);
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < BKW; ++w) {
        const int2 a = *reinterpret_cast<const int2*>(&Xw[w][ty * 2]);
        const int4 b = *reinterpret_cast<const int4*>(&Yw[w][tx * 4]);
        const int av[2] = {a.x, a.y};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j;
        const int gc = col0 + c;
        const float cross = __fmul_rn(static_cast<float>(acc[i][j]), sa[r]);
        float v = fmaxf(
            __fsub_rn(__fadd_rn(sxn[r], sy[c]), __fmul_rn(2.0f, cross)), 0.0f);
        if (euclidean) v = sqrtf(v);
        if (gc >= n || (valid != nullptr && valid[gc] == 0)) v = INFINITY;
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

template <bool GLOBAL_LISTS>
int launch(const signed char* xq, const signed char* codes, const float* alpha,
           const float* xn, const float* sqnorms, const unsigned char* valid,
           float* out_d, int* out_i, int m, int n, int d, int k, int euclidean,
           int aligned, cudaStream_t stream) {
  size_t smem = 0;  // the GLOBAL_LISTS instance keeps no lists here
  if constexpr (!GLOBAL_LISTS) {
    const cudaError_t err =
        rt::reserve_best_smem(topk_int8_kernel<false>, k, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((m + BM - 1) / BM);
  topk_int8_kernel<GLOBAL_LISTS><<<grid, THREADS, smem, stream>>>(
      xq, codes, alpha, xn, sqnorms, valid, out_d, out_i, m, n, d, k,
      euclidean, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int topk_int8(const signed char* xq, const signed char* codes,
                         const float* alpha, const float* xn,
                         const float* sqnorms, const unsigned char* valid,
                         float* out_d, int* out_i, int m, int n, int d, int k,
                         int euclidean, int aligned, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= rt::SEL_SMEM_MAX_K) {
    return launch<false>(xq, codes, alpha, xn, sqnorms, valid, out_d, out_i, m,
                         n, d, k, euclidean, aligned, s);
  }
  return launch<true>(xq, codes, alpha, xn, sqnorms, valid, out_d, out_i, m, n,
                      d, k, euclidean, aligned, s);
}
