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
// cores at 67 TFLOP/s (kNN graph 2048 x 2048 x 784: ~0.098 ms; brute batch
// 512 x 60000 x 784: ~0.72 ms; ground truth 10000 x 60000 x 784: 0.94
// TFLOP, ~14 ms).  The cube family does two f32 instructions per (i, j, l)
// (a subtraction, then an add or max that takes the absolute value as an
// operand modifier) at 33.5 T instructions/s and has no tensor-core form:
// ~0.196 ms for the kNN graph, ~28 ms for the ground truth.
//
// Design.  One call is up to three kernels, counted as one launch by the
// wrapper: the squared norms of every row of X and Y (matmul family only),
// the scan, and the merge of the splits' lists.  Each point below answers
// one limit of the first design (one block per 32-row strip, 2 x 4
// register tiles, scalar loads, norms recomputed per strip, every tile
// staged and merged behind three barriers):
//
// - Grid: (row strips) x (column splits S).  Each block scans one
//   contiguous, ascending range of columns for its strip of BM query rows
//   and keeps its own top-k of that range; with S > 1 it writes those lists
//   to a scratch (m, S, k) and merge_kernel takes, one warp per row, the k
//   smallest heads of the S lists.  kernels/topk/topk.py:split_plan picks
//   S from the shape and the card's resident blocks, so a 512-query batch
//   (8 strips of 64 rows) fills the card as 8 x 32 blocks where a grid of
//   strips alone ran 16 blocks on 132 SMs.
// - Tiles: a block is 256 threads, 8 warps; warp w owns TM consecutive
//   rows of the strip (BM = 8 * TM) and lane l the columns l + 32 j of each
//   128-column tile, so each thread keeps a TM x 4 register tile (8 x 4 for
//   k <= 64, 4 x 4 above, where the lists take the shared memory).  Per 4
//   steps of d a thread reads 4 float4 of Y and TM float4 of X (a
//   broadcast: the warp's lanes share their rows) for 16 * TM FMAs: 2.7
//   FMAs per float read at TM = 8, where 2 x 4 tiles fed 1.3.
// - Copies: X and Y slices of 32 d-values pass global -> shared by
//   cp.async (16-byte chunks where d % 4 == 0 and the rows are aligned,
//   4-byte elements otherwise; zero-filled past m, n and d) in a ring of 3
//   stages, one barrier per stage; the ring runs on across tiles, so the
//   next tile's first slices load while a tile finishes.  The shared rows
//   are d-major with a stride of 36 floats, which keeps the float4 reads of
//   a quarter-warp on distinct banks.  (Tried on the card and no faster:
//   a 4-stage ring, a 4 x 8 lane grid sharing rows across warps, 8 x 8
//   register tiles at 254 registers.)
// - Norms: |x|^2 and |y|^2 come from one pre-pass (sqnorm_kernel) into an
//   (m + n) buffer; no thread of the scan waits on a norm loop.
// - Selection: the lists are sorted by (distance, column)
//   (common.cuh:before), so the order in which survivors arrive does not
//   matter.  A warp owns its rows' lists outright: after a tile each
//   thread compares its register tile against its rows' k-th distance and
//   only survivors are written, at most CAP per row per round (a warp
//   prefix sum gives the slots), then one lane per row inserts them; the
//   survivors left over are filtered again against the tightened k-th
//   distance and go in the next round.  No block barrier is spent on
//   selection, and a tile without survivors costs one warp vote.  The
//   lists sit in shared memory up to k = 512 (BM = 64 rows up to k = 64,
//   32 rows above: 32 x 512 x 8 bytes is 128 KB); above 512 they live in
//   the scratch (or the output when S = 1), merged by the whole warp
//   (common.cuh:warp_insert_sorted).
//
// Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, CUDA
// events): brute serve batch 512 x 60000 x 784 k=10 1.758 ms (bound 0.719),
// ground truth 29.89 ms (bound 14.04), kNN graph 0.365 ms (bound 0.098),
// manhattan ground truth 43.44 ms (bound 28.08), k = 600 batch 18.93 ms
// (f32) and 19.78 ms (manhattan); the first design took ~70, 103.5, 2.345,
// 108.3, 99.3 and 120.5 ms.  PERF.md has every row.
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;          // columns per tile; lane l owns l + 32 j
constexpr int TN = BN / 32;      // columns per thread
constexpr int BK = 32;           // d per pipeline stage
constexpr int LDS = BK + 4;      // shared row stride, floats
constexpr int STAGES = 3;
constexpr int CAP = 32;          // survivors per row per round
// Must match kernels/topk/topk.py:WIDE_ROWS_K.
constexpr int WIDE_ROWS_K = 64;  // above it, 32-row strips

template <int TM, bool GLOBAL_LISTS>
size_t smem_bytes(int k) {
  constexpr int BM = TM * WARPS;
  size_t bytes = sizeof(float) * STAGES * (BM + BN) * LDS +
                 (sizeof(float) + sizeof(int)) * BM * CAP;
  if (!GLOBAL_LISTS) bytes += (sizeof(float) + sizeof(int)) * BM * (size_t)k;
  return bytes;
}

// |a|^2 of every row of X then Y, one warp per row, into norms (m + n).
__global__ void __launch_bounds__(THREADS)
    sqnorm_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ norms, int m, int n, int d) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m + n) return;
  const float* a = row < m ? X + (size_t)row * d : Y + (size_t)(row - m) * d;
  float s = 0.0f;
  for (int l = lane; l < d; l += 32) s = fmaf(a[l], a[l], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) norms[row] = s;
}

// The scan.  Lists of row r, split s: (list_d, list_i) + (r * S + s) * k,
// i.e. an (m, S, k) scratch, or the (m, k) output when S = 1.
template <int FAM, int TM, bool GLOBAL_LISTS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    topk_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ norms, float* __restrict__ list_d,
                int* __restrict__ list_i, int m, int n, int d, int k,
                int metric, int exclude_self, int cols_per_split) {
  constexpr int BM = TM * WARPS;
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) float smem[];
  float* xs_ring = smem;                       // [STAGES][BM][LDS]
  float* ys_ring = xs_ring + STAGES * BM * LDS;  // [STAGES][BN][LDS]
  float* cand_d = ys_ring + STAGES * BN * LDS;   // [BM][CAP]
  int* cand_i = reinterpret_cast<int*>(cand_d + BM * CAP);
  // Per row of the strip, each written only by the warp that owns the row:
  // the k-th distance (-inf for a row past m), |x|^2, survivors this round.
  __shared__ float thr[BM];
  __shared__ float xn[BM];
  __shared__ int cand_n[BM];

  const int S = gridDim.y;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int cbeg = split * cols_per_split;
  const int cend = min(n, cbeg + cols_per_split);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wrow = (tid / 32) * TM;  // the warp's first row in the strip

  float* bd;
  int* bi;
  size_t ld;  // between consecutive rows' lists
  if constexpr (GLOBAL_LISTS) {
    bd = list_d + ((size_t)row0 * S + split) * k;
    bi = list_i + ((size_t)row0 * S + split) * k;
    ld = (size_t)S * k;
  } else {
    bd = reinterpret_cast<float*>(cand_i + BM * CAP);
    bi = reinterpret_cast<int*>(bd + BM * k);
    ld = k;
  }

  if (lane < TM) {
    const int gr = row0 + wrow + lane;
    thr[wrow + lane] = gr < m ? INFINITY : -INFINITY;
    xn[wrow + lane] = (FAM == rt::MATMUL_FAMILY && gr < m) ? norms[gr] : 0.0f;
  }
#pragma unroll 1
  for (int i = 0; i < TM; ++i) {
    if (row0 + wrow + i < m) {
      for (int e = lane; e < k; e += 32) {
        bd[(wrow + i) * ld + e] = INFINITY;
        bi[(wrow + i) * ld + e] = -1;
      }
    }
  }
  __syncwarp();

  const int ntiles = cend > cbeg ? (cend - cbeg + BN - 1) / BN : 0;
  const int nk = (d + BK - 1) / BK;
  const int steps = ntiles * nk;

  auto load_stage = [&](int g) {
    const int slot = g % STAGES;
    const int k0 = (g % nk) * BK;
    const int col0 = cbeg + (g / nk) * BN;
    rt::load_rows<BM, BK, LDS, THREADS, VEC>(xs_ring + slot * BM * LDS, X, row0, m, k0, d, d,
                                             tid);
    rt::load_rows<BN, BK, LDS, THREADS, VEC>(ys_ring + slot * BN * LDS, Y, col0, n, k0, d, d,
                                             tid);
  };

#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < steps) load_stage(g);
    rt::cp_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < steps; ++g) {
    rt::cp_wait<STAGES - 2>();
    __syncthreads();  // stage g landed; every warp is done with stage g - 1
    if (g + STAGES - 1 < steps) load_stage(g + STAGES - 1);
    rt::cp_commit();

    const float* xs = xs_ring + (g % STAGES) * BM * LDS;
    const float* ys = ys_ring + (g % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(ys + (lane + 32 * j) * LDS + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(xs + (wrow + i) * LDS + kk);
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
    if (g % nk != nk - 1) continue;

    // The tile is done: distances, masks, and the survivors' rounds.
    const int col0 = cbeg + (g / nk) * BN;
    unsigned pend = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + lane + 32 * j;
      const bool live = gc < cend && (valid == nullptr || valid[gc] != 0);
      float yn = 0.0f;
      if constexpr (FAM == rt::MATMUL_FAMILY) {
        if (live) yn = norms[m + gc];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = acc[i][j];
        if constexpr (FAM == rt::MATMUL_FAMILY) v = rt::epilogue(metric, v, xn[wrow + i], yn);
        if (!live || (exclude_self && row0 + wrow + i == gc)) v = INFINITY;
        acc[i][j] = v;
        if (v <= thr[wrow + i] && v < INFINITY) pend |= 1u << (i * TN + j);
      }
    }
    while (__any_sync(FULL, pend != 0)) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const unsigned bits = (pend >> (i * TN)) & ((1u << TN) - 1u);
        const int c = __popc(bits);
        int incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(FULL, incl, off);
          if (lane >= off) incl += t;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        int slot = incl - c;
        float* cd = cand_d + (wrow + i) * CAP;
        int* ci = cand_i + (wrow + i) * CAP;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if ((bits >> j) & 1u) {
            if (slot < CAP) {
              cd[slot] = acc[i][j];
              ci[slot] = col0 + lane + 32 * j;
              pend &= ~(1u << (i * TN + j));
            }
            ++slot;
          }
        }
        if (lane == 0) cand_n[wrow + i] = min(total, CAP);
      }
      __syncwarp();
      if constexpr (GLOBAL_LISTS) {
#pragma unroll 1
        for (int r = wrow; r < wrow + TM; ++r) {
          const int cnt = cand_n[r];
          for (int e = 0; e < cnt; ++e)
            rt::warp_insert_sorted(bd + r * ld, bi + r * ld, k, cand_d[r * CAP + e],
                                   cand_i[r * CAP + e], lane);
        }
      } else if (lane < TM) {
        const int r = wrow + lane;
        const int cnt = cand_n[r];
        for (int e = 0; e < cnt; ++e)
          rt::insert_sorted(bd + r * ld, bi + r * ld, k, cand_d[r * CAP + e],
                            cand_i[r * CAP + e]);
      }
      __syncwarp();
      if (lane < TM && row0 + wrow + lane < m)
        thr[wrow + lane] = bd[(wrow + lane) * ld + k - 1];
      __syncwarp();
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float t = thr[wrow + i];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (!(acc[i][j] <= t)) pend &= ~(1u << (i * TN + j));
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }
  rt::cp_wait<0>();

  if constexpr (!GLOBAL_LISTS) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + wrow + i;
      if (gr >= m) break;
      float* od = list_d + ((size_t)gr * S + split) * k;
      int* oi = list_i + ((size_t)gr * S + split) * k;
      for (int e = lane; e < k; e += 32) {
        od[e] = bd[(wrow + i) * ld + e];
        oi[e] = bi[(wrow + i) * ld + e];
      }
    }
  }
}

// The k smallest of each row's S sorted lists (S <= 32), one warp per row:
// lane s holds list s's head; k rounds of a warp arg-min by (distance,
// column, lane) move the winner's head on.  An exhausted list's head is
// (+inf, INT_MAX), after every real entry and every (+inf, -1) slot.
__global__ void __launch_bounds__(THREADS)
    merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 float* __restrict__ out_d, int* __restrict__ out_i, int m,
                 int S, int k) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const float* ld = part_d + ((size_t)row * S + lane) * k;
  const int* li = part_i + ((size_t)row * S + lane) * k;
  int p = 0;
  float hd = INFINITY;
  int hi = INT_MAX;
  if (lane < S) {
    hd = ld[0];
    hi = li[0];
  }
  for (int e = 0; e < k; ++e) {
    float wd = hd;
    int wi = hi;
    int wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, wd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (rt::before(od, oi, wd, wi) || (od == wd && oi == wi && ol < wl)) {
        wd = od;
        wi = oi;
        wl = ol;
      }
    }
    if (lane == 0) {
      out_d[(size_t)row * k + e] = wd;
      out_i[(size_t)row * k + e] = wi;
    }
    if (lane == wl) {
      ++p;
      hd = p < k ? ld[p] : INFINITY;
      hi = p < k ? li[p] : INT_MAX;
    }
  }
}

struct Args {
  const float* X;
  const float* Y;
  const unsigned char* valid;
  const float* norms;
  float* list_d;
  int* list_i;
  int m, n, d, k, metric, exclude_self, splits, cols_per_split;
};

template <int FAM, int TM, bool GLOBAL_LISTS, bool VEC>
int launch_scan(const Args& a, cudaStream_t stream) {
  constexpr int BM = TM * WARPS;
  auto kernel = topk_kernel<FAM, TM, GLOBAL_LISTS, VEC>;
  const size_t smem = smem_bytes<TM, GLOBAL_LISTS>(a.k);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.m + BM - 1) / BM, a.splits);
  kernel<<<grid, THREADS, smem, stream>>>(a.X, a.Y, a.valid, a.norms, a.list_d,
                                          a.list_i, a.m, a.n, a.d, a.k, a.metric,
                                          a.exclude_self, a.cols_per_split);
  return static_cast<int>(cudaGetLastError());
}

// The instance a (family, k, alignment) runs.
template <int FAM>
int scan(const Args& a, bool vec, cudaStream_t s) {
  if (a.k > rt::SEL_SMEM_MAX_K)
    return vec ? launch_scan<FAM, 4, true, true>(a, s)
               : launch_scan<FAM, 4, true, false>(a, s);
  if (a.k > WIDE_ROWS_K)
    return vec ? launch_scan<FAM, 4, false, true>(a, s)
               : launch_scan<FAM, 4, false, false>(a, s);
  return vec ? launch_scan<FAM, 8, false, true>(a, s)
             : launch_scan<FAM, 8, false, false>(a, s);
}

template <int FAM, int TM, bool GLOBAL_LISTS>
int resident(int k, int* blocks) {
  auto kernel = topk_kernel<FAM, TM, GLOBAL_LISTS, true>;
  const size_t smem = smem_bytes<TM, GLOBAL_LISTS>(k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  return static_cast<int>(err);
}

template <int FAM>
int resident_for(int k, int* blocks) {
  if (k > rt::SEL_SMEM_MAX_K) return resident<FAM, 4, true>(k, blocks);
  if (k > WIDE_ROWS_K) return resident<FAM, 4, false>(k, blocks);
  return resident<FAM, 8, false>(k, blocks);
}

int family(int metric) {
  switch (metric) {
    case rt::SQEUCLIDEAN:
    case rt::EUCLIDEAN:
    case rt::COSINE:
    case rt::DOT:
      return rt::MATMUL_FAMILY;
    case rt::MANHATTAN:
      return rt::MANHATTAN_FAMILY;
    case rt::CHEBYSHEV:
      return rt::CHEBYSHEV_FAMILY;
    default:
      return -1;
  }
}

}  // namespace

// Blocks of the scan that one SM holds at once for this metric and k:
// kernels/topk/topk.py:split_plan sizes the grid by it.
extern "C" int topk_f32_blocks_per_sm(int metric, int k, int* blocks) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (family(metric)) {
    case rt::MATMUL_FAMILY:
      return resident_for<rt::MATMUL_FAMILY>(k, blocks);
    case rt::MANHATTAN_FAMILY:
      return resident_for<rt::MANHATTAN_FAMILY>(k, blocks);
    case rt::CHEBYSHEV_FAMILY:
      return resident_for<rt::CHEBYSHEV_FAMILY>(k, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// norms: (m + n) f32 scratch for the matmul family (null for the cube
// family).  part_d / part_i: (m, splits, k) scratch when splits > 1 (null
// otherwise).  Split s scans columns [s * cols_per_split, (s + 1) *
// cols_per_split) of n.  aligned: d % 4 == 0 and X, Y 16-byte aligned.
extern "C" int topk_f32(const float* X, const float* Y,
                        const unsigned char* valid, float* out_d, int* out_i,
                        float* norms, float* part_d, int* part_i, int m, int n,
                        int d, int k, int metric, int exclude_self, int splits,
                        int cols_per_split, int aligned, void* stream) {
  const int fam = family(metric);
  if (k < 1 || fam < 0 || splits < 1 || splits > rt::MAX_SPLITS ||
      (splits > 1 && (part_d == nullptr || part_i == nullptr)) ||
      (fam == rt::MATMUL_FAMILY && norms == nullptr) || m < 1 ||
      cols_per_split < 1 || (long long)splits * cols_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fam == rt::MATMUL_FAMILY) {
    const int err = sqnorms(X, Y, norms, m, n, d, stream);
    if (err != 0) return err;
  }
  const Args a{X, Y, valid, norms,
               splits > 1 ? part_d : out_d, splits > 1 ? part_i : out_i,
               m, n, d, k, metric, exclude_self, splits, cols_per_split};
  int err;
  if (fam == rt::MATMUL_FAMILY) {
    err = scan<rt::MATMUL_FAMILY>(a, aligned != 0, s);
  } else if (fam == rt::MANHATTAN_FAMILY) {
    err = scan<rt::MANHATTAN_FAMILY>(a, aligned != 0, s);
  } else {
    err = scan<rt::CHEBYSHEV_FAMILY>(a, aligned != 0, s);
  }
  if (err != 0 || splits == 1) return err;
  return topk_merge(part_d, part_i, out_d, out_i, m, splits, k, stream);
}

extern "C" int sqnorms(const float* X, const float* Y, float* norms, int m, int n, int d,
                       void* stream) {
  if (m < 0 || n < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m + n == 0) return 0;
  sqnorm_kernel<<<(m + n + WARPS - 1) / WARPS, THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(X, Y, norms, m, n, d);
  return static_cast<int>(cudaGetLastError());
}

// merge_kernel for both scans (topk_int8.cu's too): common.cuh declares it.
extern "C" int topk_merge(const float* part_d, const int* part_i, float* out_d,
                          int* out_i, int m, int splits, int k, void* stream) {
  if (m < 0 || k < 1 || splits < 1 || splits > rt::MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  merge_kernel<<<(m + WARPS - 1) / WARPS, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(part_d, part_i, out_d, out_i, m,
                                                      splits, k);
  return static_cast<int>(cudaGetLastError());
}
