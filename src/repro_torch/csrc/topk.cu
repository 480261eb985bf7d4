// Fused distance + streaming top-k over f32 rows: the matmul family
// (sqeuclidean, euclidean, cosine, dot) and the cube family (manhattan,
// chebyshev).
//
// Replaces the TPU kernels src/repro/kernels/topk/topk.py:_matmul_kernel
// and :_cube_kernel (entry topk_pallas; helpers _mask_tile,
// _select_and_store, _merge_topk).  For every row of X (m, d) it returns
// the k nearest rows of Y (n, d): distances (m, k) ascending and their
// column ids (m, k) int32.  Up to k = 512 it never writes the (m, n)
// distance matrix; above, it writes it in row chunks and selects from it
// (Selection above k = 512, below).  Masks: columns >= n, columns whose
// `valid` byte is 0, and the global diagonal when exclude_self is set.
// Ties go to the lowest column; slots past the valid candidates hold
// (+inf, -1).
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
// the scan, and the merge of the splits' lists (above k = 512: per row
// chunk, the scan and the select).  Each point below answers one limit of
// the first design (one block per 32-row strip, 2 x 4 register tiles,
// scalar loads, norms recomputed per strip, every tile staged and merged
// behind three barriers):
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
//   k <= 64 and k > 512, 4 x 4 between, where the lists take the shared
//   memory).  Per 4 steps of d a thread reads 4 float4 of Y and TM float4
//   of X (a broadcast: the warp's lanes share their rows) for 16 * TM FMAs:
//   2.7 FMAs per float read at TM = 8, where 2 x 4 tiles fed 1.3.
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
//   32 rows above: 32 x 512 x 8 bytes is 128 KB).
// - Selection above k = 512: a sorted running list is the wrong tool once
//   k is a large share of a split (at k = 4096 no list of a 3 840-column
//   split ever filled, and every column paid an O(k) insert in global
//   memory: ~995 ms a 512 x 60000 x 784 batch).  The scan instead writes
//   each tile's masked distances (+inf where masked) to an f32 scratch of
//   a row chunk x n, coalesced by lane, with the 8 x 4 tiles of k <= 64;
//   no list means splits cost no merge, so kernels/topk/topk.py:wide_plan
//   sizes them only to fill the card, and cuts the rows into chunks whose
//   scratch fits SCRATCH_BYTES (512 x 60000 is one chunk of 123 MB).  Then
//   merge_kernel's select overload takes one row a block: the distances
//   as order-preserving u32 keys (+inf, NaN and masked entries never
//   enter), three radix histograms (11 + 11 + 10 bits, warp-aggregated
//   shared atomics) find the exact k-th key T and how many keys equal to
//   T the row still needs, a block-ordered compaction keeps every key
//   below T and the lowest columns equal to T, and an ascending bitonic
//   network orders the survivors as 64-bit (key, column) words: in shared
//   memory up to SORT_WORDS of them, through the output row above.
//
// Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; CUDA events): brute
// serve batch 512 x 60000 x 784 k=10 1.758 ms (bound 0.719), ground truth
// 29.89 ms (bound 14.04), kNN graph 0.365 ms (bound 0.098), manhattan
// ground truth 43.44 ms (bound 28.08); the first design took ~70, 103.5,
// 2.345 and 108.3 ms.  Above k = 512 (tools/profile_topk_wide.py): the
// batch at k = 4096 2.259 ms (scan 1.557, select 0.625), k = 1024 2.156,
// k = 600 2.145 (manhattan 2.845), where the global lists took 994.8,
// 48.39, 17.08 and 17.90 ms.  PERF.md has every row.
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
constexpr int WIDE_ROWS_K = 64;  // above it, 32-row strips (k <= SEL_SMEM_MAX_K)

// The select (k > SEL_SMEM_MAX_K): one block a row.
constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int BINS = 1 << 11;    // radix digits of the first two passes
constexpr int UNROLL = 4;        // loads in flight a thread in each pass
constexpr int SORT_WORDS = 4096;  // survivors a row sorted in shared memory

// ROWS: the scan writes its distances out (k > SEL_SMEM_MAX_K); else the
// running lists sit in shared memory.
template <int TM, bool ROWS>
size_t smem_bytes(int k) {
  constexpr int BM = TM * WARPS;
  size_t bytes = sizeof(float) * STAGES * (BM + BN) * LDS;
  if (!ROWS) bytes += (sizeof(float) + sizeof(int)) * BM * (CAP + (size_t)k);
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
// i.e. an (m, S, k) scratch, or the (m, k) output when S = 1.  ROWS: rows
// [row_base, row_end) only, their distances to list_d + (r - row_base) * n
// (list_i unused).
template <int FAM, int TM, bool ROWS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    topk_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ norms, float* __restrict__ list_d,
                int* __restrict__ list_i, int m, int n, int d, int k,
                int metric, int exclude_self, int cols_per_split, int row_base,
                int row_end) {
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
  const int rows = ROWS ? row_end : m;  // rows past it are not this call's
  const int row0 = (ROWS ? row_base : 0) + blockIdx.x * BM;
  const int cbeg = split * cols_per_split;
  const int cend = min(n, cbeg + cols_per_split);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wrow = (tid / 32) * TM;  // the warp's first row in the strip

  // the strip's lists, in shared memory
  float* bd = reinterpret_cast<float*>(cand_i + BM * CAP);
  int* bi = reinterpret_cast<int*>(bd + BM * k);
  const size_t ld = k;  // between consecutive rows' lists

  if (lane < TM) {
    const int gr = row0 + wrow + lane;
    thr[wrow + lane] = gr < rows ? INFINITY : -INFINITY;
    xn[wrow + lane] = (FAM == rt::MATMUL_FAMILY && gr < rows) ? norms[gr] : 0.0f;
  }
  if constexpr (!ROWS) {
#pragma unroll 1
    for (int i = 0; i < TM; ++i) {
      if (row0 + wrow + i < m) {
        for (int e = lane; e < k; e += 32) {
          bd[(wrow + i) * ld + e] = INFINITY;
          bi[(wrow + i) * ld + e] = -1;
        }
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
    rt::load_rows<BM, BK, LDS, THREADS, VEC>(xs_ring + slot * BM * LDS, X, row0, rows, k0, d,
                                             d, tid);
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

    // The tile is done: distances, masks, and the survivors' rounds (or,
    // ROWS, the distances written out, a warp's 32 lanes on 32 adjacent
    // columns of one row).
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
        if constexpr (ROWS) {
          if (gc < cend && row0 + wrow + i < rows)
            list_d[(size_t)(row0 + wrow + i - row_base) * n + gc] = v;
        } else {
          acc[i][j] = v;
          if (v <= thr[wrow + i] && v < INFINITY) pend |= 1u << (i * TN + j);
        }
      }
    }
    while (!ROWS && __any_sync(FULL, pend != 0)) {
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
      if (lane < TM) {
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

  if constexpr (!ROWS) {
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

// ---------------------------------------------------------------------------
// the select (k > SEL_SMEM_MAX_K): the k smallest of one row of distances
// ---------------------------------------------------------------------------

// u32 keys in the order of the floats (-0 taken as +0, so the two tie).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__device__ __forceinline__ unsigned long long word(unsigned key, int col) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(col);
}

// hist[digit] += 1 for each lane with `on`, one shared atomic per distinct
// digit of the warp (a row's distances crowd into few top digits).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, bool on,
                                         int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, on ? digit : 0xffffffffu);
  if (on && lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
}

// The digit whose bin holds the want-th smallest (1-based) of the
// histogram's entries: sel[0] = the digit, sel[1] = entries below its bin;
// sel[2] = all entries.  Nothing is found when want > sel[2].
__device__ void find_digit(const unsigned* hist, unsigned want, unsigned* sel,
                           unsigned* sums) {
  constexpr int PER = BINS / SEL_THREADS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  unsigned own[PER];
  unsigned s = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    own[q] = hist[tid * PER + q];
    s += own[q];
  }
  unsigned incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < SEL_WARPS ? sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < SEL_WARPS) sums[lane] = w;
  }
  __syncthreads();
  unsigned below = (warp ? sums[warp - 1] : 0u) + incl - s;
  if (tid == 0) sel[2] = sums[SEL_WARPS - 1];
  if (below < want && want <= below + s) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      if (want <= below + own[q]) {
        sel[0] = tid * PER + q;
        sel[1] = below;
        break;
      }
      below += own[q];
    }
  }
  __syncthreads();
}

// The smaller (key, column) word of entries i < j to i: in shared words,
// or in the output row (keys as bits in od, columns in oi).
__device__ __forceinline__ void cmp_swap(unsigned long long* w, int i, int j) {
  const unsigned long long a = w[i], b = w[j];
  if (b < a) {
    w[i] = b;
    w[j] = a;
  }
}

__device__ __forceinline__ void cmp_swap(unsigned* keys, int* cols, int i, int j) {
  const unsigned ki = keys[i], kj = keys[j];
  const int ci = cols[i], cj = cols[j];
  if (word(kj, cj) < word(ki, ci)) {
    keys[i] = kj;
    keys[j] = ki;
    cols[i] = cj;
    cols[j] = ci;
  }
}

// One step of the ascending bitonic network over [0, cnt), entries past
// cnt taken as +inf: `flip` pairs i with its mirror in its block of
// `size`, else with i + stride, and swap(i, j) puts the smaller at i.  A
// pair with j >= cnt keeps its order, so no padding is stored.
template <class Swap>
__device__ __forceinline__ void bitonic_step(int cnt, int size, int stride, bool flip,
                                             Swap swap) {
  const int half = flip ? size / 2 : stride;
  for (int t = threadIdx.x;; t += SEL_THREADS) {
    const int i = (t / half) * 2 * half + t % half;
    if (i >= cnt) break;
    const int j = flip ? (i ^ (size - 1)) : i + half;
    if (j < cnt) swap(i, j);
  }
  __syncthreads();
}

// Sizes [first_size, last_size] of the network over the shared words
// w[0, cnt); with first_size > 2, only the steps of stride < SORT_WORDS
// of each size run here (the larger ones ran over the output row).
__device__ void bitonic_shared(unsigned long long* w, int cnt, int first_size,
                               int last_size) {
  auto swap = [w](int i, int j) { cmp_swap(w, i, j); };
  for (int size = first_size; size <= last_size; size <<= 1) {
    int stride = SORT_WORDS / 2;
    if (size <= SORT_WORDS) {
      bitonic_step(cnt, size, 0, true, swap);
      stride = size / 4;
    }
    for (; stride > 0; stride >>= 1) bitonic_step(cnt, size, stride, false, swap);
  }
}

// The k smallest of one row of n distances a block, ascending by (distance,
// column), (+inf, -1) past the alive entries.  An overload of the lists'
// merge, so that every kernel of a call carries one of the scan's names.
template <int NT>
__global__ void __launch_bounds__(NT, 4)
    merge_kernel(const float* __restrict__ dist, int n, float* __restrict__ out_d,
                 int* __restrict__ out_i, int k) {
  static_assert(NT == SEL_THREADS, "the select's helpers assume SEL_THREADS");
  __shared__ unsigned hist[BINS];
  __shared__ unsigned long long words[SORT_WORDS];
  __shared__ unsigned sums[2 * SEL_WARPS];
  __shared__ unsigned sel[3];
  const float* row = dist + (size_t)blockIdx.x * n;
  float* od = out_d + (size_t)blockIdx.x * k;
  int* oi = out_i + (size_t)blockIdx.x * k;
  unsigned* okeys = reinterpret_cast<unsigned*>(od);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // The k-th key T: 11, 11 and 10 bits; want = its rank among the keys
  // that share the digits found so far.  Fewer than k alive: take them all.
  unsigned prefix = 0, want = static_cast<unsigned>(k);
  bool all = false;
  int cnt = k;
#pragma unroll 1
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0;
    const unsigned mask = pass == 2 ? 0x3ffu : 0x7ffu;
    const int above = shift + (pass == 2 ? 10 : 11);
    for (int b = tid; b < BINS; b += NT) hist[b] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += NT * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = base + u * NT + tid;
        v[u] = c < n ? row[c] : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned key = order_key(v[u]);
        const bool on = v[u] < INFINITY && (pass == 0 || (key >> above) == (prefix >> above));
        hist_add(hist, (key >> shift) & mask, on, lane);
      }
    }
    __syncthreads();
    find_digit(hist, want, sel, sums);
    if (pass == 0 && sel[2] <= want) {
      all = true;
      cnt = static_cast<int>(sel[2]);
      break;
    }
    prefix |= sel[0] << shift;
    want -= sel[1];
  }
  const int need = all ? 0 : static_cast<int>(want);  // keys equal to T to keep
  const bool shared = cnt <= SORT_WORDS;

  // Compaction in column order: every alive key below T, and the first
  // `need` keys equal to T.  Ranks from two ballots and the warps' counts
  // (two buffers, so one barrier a tile).
  int taken = 0, eq_seen = 0;
  for (int base = 0, buf = 0; base < n; base += NT, buf ^= 1) {
    const int c = base + tid;
    const float v = c < n ? row[c] : INFINITY;
    const unsigned key = order_key(v);
    const bool alive = v < INFINITY;
    const bool less = alive && (all || key < prefix);
    const bool eq = alive && !all && key == prefix;
    const unsigned bl = __ballot_sync(0xffffffffu, less);
    const unsigned be = __ballot_sync(0xffffffffu, eq);
    unsigned* ws = sums + buf * SEL_WARPS;  // low half: less, high: equal
    if (lane == 0) ws[warp] = __popc(bl) | (__popc(be) << 16);
    __syncthreads();
    int lb = 0, eb = 0, lt = 0, et = 0;
#pragma unroll
    for (int w = 0; w < SEL_WARPS; ++w) {
      const unsigned x = ws[w];
      if (w < warp) {
        lb += x & 0xffffu;
        eb += x >> 16;
      }
      lt += x & 0xffffu;
      et += x >> 16;
    }
    const unsigned below = (1u << lane) - 1u;
    const int lrank = lb + __popc(bl & below);
    const int erank = eb + __popc(be & below);
    const int avail = max(0, need - eq_seen);
    if (less || (eq && erank < avail)) {
      const int pos = taken + lrank + min(erank, avail);
      if (shared) {
        words[pos] = word(key, c);
      } else {
        okeys[pos] = key;
        oi[pos] = c;
      }
    }
    taken += lt + min(et, avail);
    eq_seen += et;
  }
  __syncthreads();

  // Order by (key, column).
  int n2 = 1;
  while (n2 < cnt) n2 <<= 1;
  if (shared) {
    bitonic_shared(words, cnt, 2, n2);
  } else {
    // each chunk of SORT_WORDS in shared memory, then the larger sizes:
    // their steps of stride >= SORT_WORDS over the row, the rest a chunk
    // at a time in shared memory
    auto chunks = [&](int first_size, int last_size) {
      for (int c0 = 0; c0 < cnt; c0 += SORT_WORDS) {
        const int len = min(SORT_WORDS, cnt - c0);
        for (int e = tid; e < len; e += NT) words[e] = word(okeys[c0 + e], oi[c0 + e]);
        __syncthreads();
        bitonic_shared(words, len, first_size, last_size);
        for (int e = tid; e < len; e += NT) {
          okeys[c0 + e] = static_cast<unsigned>(words[e] >> 32);
          oi[c0 + e] = static_cast<int>(words[e] & 0xffffffffu);
        }
        __syncthreads();
      }
    };
    chunks(2, SORT_WORDS);
    auto swap = [okeys, oi](int i, int j) { cmp_swap(okeys, oi, i, j); };
    for (int size = 2 * SORT_WORDS; size <= n2; size <<= 1) {
      bitonic_step(cnt, size, 0, true, swap);
      for (int stride = size / 4; stride >= SORT_WORDS; stride >>= 1)
        bitonic_step(cnt, size, stride, false, swap);
      chunks(size, size);
    }
  }

  for (int e = tid; e < k; e += NT) {
    if (e < cnt) {
      const unsigned long long w = shared ? words[e] : word(okeys[e], oi[e]);
      od[e] = key_value(static_cast<unsigned>(w >> 32));
      oi[e] = static_cast<int>(w & 0xffffffffu);
    } else {
      od[e] = INFINITY;
      oi[e] = -1;
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
  int m, n, d, k, metric, exclude_self, splits, cols_per_split, row_base, row_end;
};

template <int FAM, int TM, bool ROWS, bool VEC>
int launch_scan(const Args& a, cudaStream_t stream) {
  constexpr int BM = TM * WARPS;
  auto kernel = topk_kernel<FAM, TM, ROWS, VEC>;
  const size_t smem = smem_bytes<TM, ROWS>(a.k);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.row_end - a.row_base + BM - 1) / BM, a.splits);
  kernel<<<grid, THREADS, smem, stream>>>(a.X, a.Y, a.valid, a.norms, a.list_d,
                                          a.list_i, a.m, a.n, a.d, a.k, a.metric,
                                          a.exclude_self, a.cols_per_split, a.row_base,
                                          a.row_end);
  return static_cast<int>(cudaGetLastError());
}

// The instance a (family, k, alignment) runs.
template <int FAM>
int scan(const Args& a, bool vec, cudaStream_t s) {
  if (a.k > rt::SEL_SMEM_MAX_K)
    return vec ? launch_scan<FAM, 8, true, true>(a, s)
               : launch_scan<FAM, 8, true, false>(a, s);
  if (a.k > WIDE_ROWS_K)
    return vec ? launch_scan<FAM, 4, false, true>(a, s)
               : launch_scan<FAM, 4, false, false>(a, s);
  return vec ? launch_scan<FAM, 8, false, true>(a, s)
             : launch_scan<FAM, 8, false, false>(a, s);
}

template <int FAM, int TM, bool ROWS>
int resident(int k, int* blocks) {
  auto kernel = topk_kernel<FAM, TM, ROWS, true>;
  const size_t smem = smem_bytes<TM, ROWS>(k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  return static_cast<int>(err);
}

template <int FAM>
int resident_for(int k, int* blocks) {
  if (k > rt::SEL_SMEM_MAX_K) return resident<FAM, 8, true>(k, blocks);
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

int scan_family(int fam, const Args& a, bool vec, cudaStream_t s) {
  if (fam == rt::MATMUL_FAMILY) return scan<rt::MATMUL_FAMILY>(a, vec, s);
  if (fam == rt::MANHATTAN_FAMILY) return scan<rt::MANHATTAN_FAMILY>(a, vec, s);
  return scan<rt::CHEBYSHEV_FAMILY>(a, vec, s);
}

}  // namespace

// Blocks of the scan that one SM holds at once for this metric and k:
// kernels/topk/topk.py:split_plan and :wide_plan size the grid by it.
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
// family).  Split s scans columns [s * cols_per_split, (s + 1) *
// cols_per_split) of n.  aligned: d % 4 == 0 and X, Y 16-byte aligned.
// k <= SEL_SMEM_MAX_K: part_d / part_i are an (m, splits, k) scratch when
// splits > 1 (null otherwise; at most MAX_SPLITS), chunk_rows is unused.
// Above: part_d is a (chunk_rows, n) f32 scratch (part_i unused), and each
// chunk of chunk_rows rows is scanned, then selected.
extern "C" int topk_f32(const float* X, const float* Y,
                        const unsigned char* valid, float* out_d, int* out_i,
                        float* norms, float* part_d, int* part_i, int m, int n,
                        int d, int k, int metric, int exclude_self, int splits,
                        int cols_per_split, int chunk_rows, int aligned, void* stream) {
  const int fam = family(metric);
  const bool rows = k > rt::SEL_SMEM_MAX_K;
  if (k < 1 || fam < 0 || splits < 1 || m < 1 || n < 0 || cols_per_split < 1 ||
      (long long)splits * cols_per_split < n ||
      (fam == rt::MATMUL_FAMILY && norms == nullptr) ||
      (rows ? (part_d == nullptr || chunk_rows < 1 || splits > 65535)
            : (splits > rt::MAX_SPLITS ||
               (splits > 1 && (part_d == nullptr || part_i == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fam == rt::MATMUL_FAMILY) {
    const int err = sqnorms(X, Y, norms, m, n, d, stream);
    if (err != 0) return err;
  }
  if (!rows) {
    const Args a{X, Y, valid, norms,
                 splits > 1 ? part_d : out_d, splits > 1 ? part_i : out_i,
                 m, n, d, k, metric, exclude_self, splits, cols_per_split, 0, m};
    const int err = scan_family(fam, a, aligned != 0, s);
    if (err != 0 || splits == 1) return err;
    return topk_merge(part_d, part_i, out_d, out_i, m, splits, k, stream);
  }
  for (int r0 = 0; r0 < m; r0 += chunk_rows) {
    const int r1 = min(m, r0 + chunk_rows);
    const Args a{X, Y, valid, norms, part_d, nullptr, m, n, d, k, metric,
                 exclude_self, splits, cols_per_split, r0, r1};
    int err = scan_family(fam, a, aligned != 0, s);
    if (err != 0) return err;
    merge_kernel<SEL_THREADS><<<r1 - r0, SEL_THREADS, 0, s>>>(
        part_d, n, out_d + (size_t)r0 * k, out_i + (size_t)r0 * k, k);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
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
