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
// Exactness: the cross term accumulates in int32 on the tensor cores,
// which is exact (|acc| <= 127^2 * d), and is converted to f32 once,
// rounded to nearest; the epilogue is written with the _rn intrinsics so
// nvcc cannot contract it into an FMA, in the plain version's order
// (kernels/topk/ref.py:quant_dists): (xn + sqnorms) - 2 * (acc * alpha),
// then fmaxf and an IEEE square root.  Distances and ids equal the plain
// version's bit for bit, ties included.
//
// Bound on an H100: 2*m*n*d int8 operations at the dense int8 tensor-core
// peak (1979 TOPS): a 512-query serve batch over 60000 x 784 is 0.024 ms,
// the 10000-query set 0.475 ms; the bytes (codes read once, n*d) are far
// below the operations.
//
// Design.  One call is the scan and, with more than one column split, the
// merge of the splits' lists (topk.cu's merge_kernel, through topk_merge),
// counted as one launch by the wrapper.  Each point answers one limit of
// the first design (one block per 32-row strip, __dp4a on the CUDA cores,
// word-by-word operand loads behind two barriers per 64-byte slice, every
// tile staged and selected behind two more, one lane inserting):
//
// - Grid: (row strips) x (column splits S), as in topk.cu.  Each block
//   scans one contiguous, ascending column range for its strip and keeps
//   its own top-k of that range; with S > 1 the lists go to an (m, S, k)
//   scratch and topk_merge takes the k smallest by (distance, column).
//   kernels/topk/topk.py:split_plan picks S from the shape and the blocks
//   one SM holds (topk_int8_blocks_per_sm): a 512-query batch (4 strips of
//   128 rows) runs 4 x 32 blocks where the strips alone ran 16.  The
//   splits share a per-row bound, the least k-th distance any of them has
//   reached (atomicMin): a candidate after another split's k-th cannot be
//   in the row's top k, so each split filters by the better of the two.
// - Cross term: mma.sync m16n8k32 s8 x s8 -> s32.  Each warp owns 16 query
//   rows (one m16 fragment) and the whole 128-column tile (16 n8
//   fragments, 64 int32 accumulators a thread).  Both operands are
//   d-contiguous, which is what the instruction wants (A row-major, B
//   "col": codes (n, d) row-major), so ldmatrix feeds the fragments from
//   shared memory without a transpose; the next pair of B fragments loads
//   while the current pair multiplies.
// - Copies: xq and codes slices of 128 d-bytes pass global -> shared by
//   cp.async in a ring of 3 stages, one barrier per stage; 16-byte chunks
//   where d % 16 == 0 and both bases are 16-byte aligned (the VEC
//   instance), 4-byte words or single bytes otherwise, zero-filled past m,
//   the split's last column and d (zeros add nothing to an int32 sum).  A
//   k32 step wholly past d is skipped.  Shared rows are 144 bytes apart,
//   so the 8 rows one ldmatrix matrix reads fall on 8 distinct 16-byte
//   bank groups.  The tile's |dec(c)|^2 and mask ride with its last stage,
//   so the epilogue reads no global memory.
// - Selection: rows are warp-owned, so no block barrier is spent on it.
//   After a tile each thread turns its accumulators into squared distances
//   (masks applied) and compares them with its two rows' bounds in that
//   domain (sq_bound), so only survivors take a square root.  The
//   survivors of a row (held by the 4 lanes of a quad) get slots from a
//   prefix sum over the quad, at most CAP per row per round; rows with few
//   are inserted by their owner lanes side by side, rows with many are
//   merged by the whole warp (warp_merge), into lists sorted by (distance,
//   column) (a quad offers its columns out of order).  Survivors left over
//   are filtered again against the tightened bound and go in the next
//   round.  The lists sit in shared memory up to k = 512 (strips of 128
//   rows up to k = 64, 32 rows above); above 512 they live in the scratch
//   (or the output when S = 1), merged by the whole warp
//   (common.cuh:warp_insert_sorted), in strips of 128 rows.
//
// Readings on an NVIDIA H100 80GB HBM3 at 700 W (tools/profile_topk_int8.py,
// CUDA events, the wrapper's query preparation included; the spread is
// that of three timings of this code in one run): a 512-query batch over
// 60000 x 784 at K = 64 in 0.78-0.82 ms (the first design: 20.78 ms;
// chip_smoke.py's _int_mm + topk: 1.33 ms), the 10000-query set in
// 6.2-6.4 ms (31.77; 22.0).  What holds it: with every column masked (no
// survivors: the copies, the mma loop, the epilogue, the merge) the batch
// reads 0.32 ms, so selection in each split's first tiles, where most
// columns survive, is the larger half there; at the whole set (3.50 ms
// masked) the scan is.  The owner / warp split of the inserts (MERGE_MIN)
// is the measured choice: owner lanes alone read 0.90 ms at the batch, the
// warp merge alone 7.44 ms at the whole set, the split 0.79 and 6.22 in
// the same rounds; the chunked insert against common.cuh's one-slot
// insert 0.79 against 0.97 ms at the batch.  Within the scan every warp
// reloads the whole B tile through ldmatrix, so shared-memory bandwidth
// rather than the tensor cores is the suspect for the mma loop (wgmma,
// which reads B from shared memory itself, is the lever).  PERF.md row 3
// has every number.
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 256;
constexpr int WROWS = 16;       // query rows per warp: one m16 fragment
constexpr int BN = 128;         // columns per tile
constexpr int NF = BN / 8;      // n8 fragments per tile
constexpr int BK = 128;         // d-bytes per pipeline stage: four k32 steps
constexpr int LDS = BK + 16;    // shared row stride, bytes
constexpr int STAGES = 3;
constexpr int CAP = 32;         // survivors per row per round
constexpr int CAPS = CAP + 1;   // survivor slots a row, padded: see the kernel
// A row with this many survivors in a round is merged by the whole warp;
// rows with fewer are inserted by their owner lanes, side by side.
constexpr int MERGE_MIN = 8;
// Must match kernels/topk/topk.py:_copy_width.
enum Copy : int { COPY_BYTES = 1, COPY_WORDS = 4, COPY_CHUNKS = 16 };

// Per stage of the ring: rows x LDS bytes of xq, BN x LDS of codes, and
// the tile's |dec(c)|^2 (BN floats) and valid bytes (BN), loaded with the
// tile's last stage.
constexpr int TILE_EXTRA = BN * (sizeof(float) + 1);

size_t smem_bytes(int rows, int k, bool global_lists) {
  size_t bytes = static_cast<size_t>(STAGES) * ((rows + BN) * LDS + TILE_EXTRA) +
                 (sizeof(float) + sizeof(int)) * static_cast<size_t>(rows) * CAPS;
  if (!global_lists) bytes += (sizeof(float) + sizeof(int)) * static_cast<size_t>(rows) * (k + 1);
  return bytes;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

// `have` (0-4) bytes from src, zeros after them.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int have) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(have));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 16-byte matrices from shared memory; lane l names row l % 8 of
// matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// common.cuh:insert_sorted with a binary search for the position, then
// the tail moves up one slot eight entries at a time (a chunk's loads
// issue together, then its stores): an insert at position p waits on about
// log2(k) + (k - p) / 8 shared-memory round trips instead of k - p, which
// read faster than the plain loop on an H100 for this kernel's lists.
__device__ __forceinline__ void insert_sorted_chunked(float* bd, int* bi, int k, float v,
                                                      int col) {
  if (!rt::before(v, col, bd[k - 1], bi[k - 1])) return;
  int lo = 0;
  int hi = k - 1;  // the first entry after (v, col) lies in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (rt::before(v, col, bd[mid], bi[mid])) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int e = k - 1;
  for (; e - 8 >= lo; e -= 8) {
    float dv[8];
    int iv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dv[j] = bd[e - 1 - j];
      iv[j] = bi[e - 1 - j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bd[e - j] = dv[j];
      bi[e - j] = iv[j];
    }
  }
  for (; e > lo; --e) {
    bd[e] = bd[e - 1];
    bi[e] = bi[e - 1];
  }
  bd[lo] = v;
  bi[lo] = col;
}

// Merge a row's survivors of one round into its sorted list L, by the
// whole warp: lane i < c holds survivor i (unsorted).  A survivor lands at
// (the list entries before it, by binary search) + (the survivors before
// it); list entry j moves up by the survivors before it, i.e. those whose
// own count of list entries before them is at most j; whatever lands at k
// or above drops out.  The list is read a 32-entry chunk at a time, top
// chunk first, each chunk before it is written, so the merge runs in
// place: a row with many survivors pays one pass over its list, not one
// insert each.
__device__ __forceinline__ void warp_merge(float* L, int* Li, int k, int c, float cv, int cc,
                                           int lane) {
  int rc = 0;  // survivors before mine
  for (int i0 = 0; i0 < c; i0 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float ov = __shfl_sync(FULL, cv, i0 + u);
      const int oc = __shfl_sync(FULL, cc, i0 + u);
      rc += (i0 + u < c && rt::before(ov, oc, cv, cc)) ? 1 : 0;
    }
  }
  int lo = 0;  // list entries before mine
  int hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (rt::before(L[mid], Li[mid], cv, cc)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  for (int base = (k - 1) / 32 * 32; base >= 0; base -= 32) {
    const int j = base + lane;
    int moves = 0;
    for (int i0 = 0; i0 < c; i0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int at = __shfl_sync(FULL, lo, i0 + u);
        moves += (i0 + u < c && at <= j) ? 1 : 0;
      }
    }
    float dv = 0.0f;
    int iv = 0;
    if (j < k) {
      dv = L[j];
      iv = Li[j];
    }
    __syncwarp();
    if (j < k && j + moves < k) {
      L[j + moves] = dv;
      Li[j + moves] = iv;
    }
    __syncwarp();
  }
  if (lane < c && lo + rc < k) {
    L[lo + rc] = cv;
    Li[lo + rc] = cc;
  }
  __syncwarp();
}

// Rows [r0, r0 + R) x d-bytes [k0, k0 + BK) of A (rows x d int8) into dst
// (R x LDS bytes), zero past `rows` and d.
template <bool VEC>
__device__ __forceinline__ void load_slice(unsigned char* dst, const signed char* A, int r0,
                                           int R, int rows, int k0, int d, int copy, int tid,
                                           int nthreads) {
  if constexpr (VEC) {
    constexpr int CH = BK / 16;
    for (int e = tid; e < R * CH; e += nthreads) {
      const int r = e / CH;
      const int c = (e % CH) * 16;
      const bool ok = r0 + r < rows && k0 + c < d;
      cp_async16(dst + r * LDS + c, ok ? A + (size_t)(r0 + r) * d + k0 + c : A, ok);
    }
  } else if (copy == COPY_WORDS) {
    constexpr int CH = BK / 4;
    for (int e = tid; e < R * CH; e += nthreads) {
      const int r = e / CH;
      const int c = (e % CH) * 4;
      const bool ok = r0 + r < rows && k0 + c < d;
      cp_async4(dst + r * LDS + c, ok ? A + (size_t)(r0 + r) * d + k0 + c : A, ok ? 4 : 0);
    }
  } else {
    for (int e = tid; e < R * BK; e += nthreads) {
      const int r = e / BK;
      const int c = e % BK;
      const bool ok = r0 + r < rows && k0 + c < d;
      dst[r * LDS + c] = ok ? static_cast<unsigned char>(A[(size_t)(r0 + r) * d + k0 + c]) : 0;
    }
  }
}

// The largest x with sqrt_rn(x) <= thr: a candidate's euclidean distance
// passes thr exactly when its squared distance passes this, so the scan
// takes a square root only for survivors.  thr * thr lies within an ulp
// or two of it; +-inf maps to itself.
__device__ __forceinline__ float sq_bound(float thr) {
  if (!(thr < INFINITY) || thr < 0.0f) return thr;
  float x = __fmul_rn(thr, thr);
  while (x > 0.0f && __fsqrt_rn(x) > thr) x = __int_as_float(__float_as_int(x) - 1);
  for (;;) {
    const float up = __int_as_float(__float_as_int(x) + 1);
    if (!(__fsqrt_rn(up) <= thr)) return x;
    x = up;
  }
}

// The scan.  A block is rows / 16 warps over `rows` query rows.  The
// launch bound promises ptxas one resident block (the shared memory of a
// 128-row block allows no more): left to aim at two, it held the 16-byte
// instances to 128 registers and spilled 756 bytes in the global-list one.  Lists of
// row r, split s: (list_d, list_i) + (r * S + s) * k, i.e. an (m, S, k)
// scratch, or the (m, k) output when S = 1.  bound (m,) holds, with S > 1,
// the least k-th distance any split of each row has reached (+inf before):
// a candidate after it cannot be in the row's top k.
template <bool GLOBAL_LISTS, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    topk_int8_kernel(const signed char* __restrict__ xq, const signed char* __restrict__ codes,
                     const float* __restrict__ alpha, const float* __restrict__ xn,
                     const float* __restrict__ sqnorms, const unsigned char* __restrict__ valid,
                     float* __restrict__ list_d, int* __restrict__ list_i, float* bound, int m,
                     int n, int d, int k, int euclidean, int copy, int cols_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int BM = nthreads / 32 * WROWS;
  unsigned char* a_ring = smem;                        // [STAGES][BM][LDS]
  unsigned char* b_ring = a_ring + STAGES * BM * LDS;  // [STAGES][BN][LDS]
  float* yn_ring = reinterpret_cast<float*>(b_ring + STAGES * BN * LDS);  // [STAGES][BN]
  unsigned char* v_ring = reinterpret_cast<unsigned char*>(yn_ring + STAGES * BN);
  // Survivor slots [BM][CAPS]: the padding puts slot e of the 16 rows a
  // warp inserts on 16 distinct banks.
  float* cand_d = reinterpret_cast<float*>(v_ring + STAGES * BN);
  int* cand_i = reinterpret_cast<int*>(cand_d + BM * CAPS);

  const int S = gridDim.y;
  const int split = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int cbeg = split * cols_per_split;
  const int cend = min(n, cbeg + cols_per_split);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wrow = (tid / 32) * WROWS;  // the warp's first row in the strip
  const int g = lane / 4;               // rows wrow + g and wrow + g + 8
  const int t = lane % 4;               // columns 8 f + 2 t, 8 f + 2 t + 1

  // Strip row r's list: bd + r * ld, a row of the scratch (global lists)
  // or of shared memory, k + 1 apart there: entry e of the 16 rows that
  // owner lanes insert into then falls on 16 distinct banks.
  float* bd;
  int* bi;
  size_t ld;
  if constexpr (GLOBAL_LISTS) {
    bd = list_d + ((size_t)row0 * S + split) * k;
    bi = list_i + ((size_t)row0 * S + split) * k;
    ld = (size_t)S * k;
  } else {
    bd = reinterpret_cast<float*>(cand_i + BM * CAPS);
    bi = reinterpret_cast<int*>(bd + BM * (k + 1));
    ld = k + 1;
  }

  float ra[2], rxn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + wrow + g + 8 * h;
    ra[h] = gr < m ? alpha[gr] : 1.0f;
    rxn[h] = gr < m ? xn[gr] : 0.0f;
  }
  // Lane r < 16 owns row wrow + r: its list's k-th distance (-inf past m)
  // and, with splits, the row's bound as last read.
  const int orow = row0 + wrow + lane;
  const bool owner = lane < WROWS && orow < m;
  float kth = owner ? INFINITY : -INFINITY;
  float gb = INFINITY;  // bound[orow], read once a tile
#pragma unroll 1
  for (int i = 0; i < WROWS; ++i) {
    if (row0 + wrow + i < m) {
      for (int e = lane; e < k; e += 32) {
        bd[(wrow + i) * ld + e] = INFINITY;
        bi[(wrow + i) * ld + e] = -1;
      }
    }
  }
  __syncwarp();
  float t2[2];  // rows wrow + g + 8 h pass when their squared distance <= t2[h]
  {
    const float own = euclidean ? sq_bound(kth) : kth;
    t2[0] = __shfl_sync(FULL, own, g);
    t2[1] = __shfl_sync(FULL, own, g + 8);
  }

  const int ntiles = cend > cbeg ? (cend - cbeg + BN - 1) / BN : 0;
  const int nk = max(1, (d + BK - 1) / BK);
  const int steps = ntiles * nk;

  // The next stage to load: its index, d-chunk and column tile.
  int ls = 0, lk = 0, lcol = cbeg;
  auto load_next = [&]() {
    if (ls < steps) {
      const int slot = ls % STAGES;
      load_slice<VEC>(a_ring + slot * BM * LDS, xq, row0, BM, m, lk * BK, d, copy, tid,
                      nthreads);
      load_slice<VEC>(b_ring + slot * BN * LDS, codes, lcol, BN, cend, lk * BK, d, copy, tid,
                      nthreads);
      if (lk == nk - 1) {  // the tile's norms and mask, zero past cend
        for (int c = tid; c < BN; c += nthreads) {
          const bool ok = lcol + c < cend;
          cp_async4(yn_ring + slot * BN + c, ok ? sqnorms + lcol + c : sqnorms, ok ? 4 : 0);
        }
        for (int w = tid; valid != nullptr && w < BN / 4; w += nthreads) {
          const int c = lcol + 4 * w;
          const int have = max(0, min(4, cend - c));
          cp_async4(v_ring + slot * BN + 4 * w, have > 0 ? valid + c : valid, have);
        }
      }
    }
    cp_commit();
    ++ls;
    if (++lk == nk) {
      lk = 0;
      lcol += BN;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();

  // ldmatrix row addresses: A matrices (rows 0-7 | 8-15) x (bytes 0-15 |
  // 16-31) give a0..a3; B matrices (bytes 0-15 | 16-31) x (columns 0-7 |
  // 8-15) give b0, b1 of two n8 fragments.
  const unsigned a_off = (wrow + (lane & 15)) * LDS + (lane >> 4) * 16;
  const unsigned b_off = ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 16;

  int acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0;

  int ck = 0, col0 = cbeg;  // the stage computed: its d-chunk and column tile
  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    load_next();

    const int slot = s % STAGES;
    if (ck == 0 && owner && bound != nullptr)
      gb = *reinterpret_cast<volatile float*>(bound + orow);  // used at the tile's end
    const unsigned as = smem_addr(a_ring + slot * BM * LDS) + a_off;
    const unsigned bs = smem_addr(b_ring + slot * BN * LDS) + b_off;
    const int k0 = ck * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      if (k0 + kk >= d) break;  // uniform: the rest of the stage is zeros
      // the next pair of B fragments loads while this pair multiplies
      unsigned a[4];
      unsigned b[2][4];
      ldmatrix_x4(a, as + kk);
      ldmatrix_x4(b[0], bs + kk);
#pragma unroll
      for (int f = 0; f < NF; f += 2) {
        const int cur = (f / 2) & 1;
        if (f + 2 < NF) ldmatrix_x4(b[cur ^ 1], bs + (f + 2) * 8 * LDS + kk);
        mma_s8(acc[f], a, b[cur][0], b[cur][1]);
        mma_s8(acc[f + 1], a, b[cur][2], b[cur][3]);
      }
    }
    if (++ck < nk) continue;
    ck = 0;

    // The tile is done.  Squared distances (kept in acc as f32 bits),
    // masks, then the survivors' rounds; acc[f][2 h + e] is row
    // wrow + g + 8 h, column col0 + 8 f + 2 t + e.
    if (bound != nullptr) {  // the other splits' best k-th distances
      const float own = euclidean ? sq_bound(fminf(kth, gb)) : fminf(kth, gb);
      t2[0] = __shfl_sync(FULL, own, g);
      t2[1] = __shfl_sync(FULL, own, g + 8);
    }
    const float* ys = yn_ring + slot * BN;
    const unsigned char* vs = v_ring + slot * BN;
    unsigned pend[2] = {0u, 0u};
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * f + 2 * t + e;
        const bool live = col0 + c < cend && (valid == nullptr || vs[c] != 0);
        const float yn = ys[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float cross = __fmul_rn(__int2float_rn(acc[f][2 * h + e]), ra[h]);
          float v = fmaxf(__fsub_rn(__fadd_rn(rxn[h], yn), __fmul_rn(2.0f, cross)), 0.0f);
          if (!live) v = INFINITY;
          acc[f][2 * h + e] = __float_as_int(v);
          if (v <= t2[h] && v < INFINITY) pend[h] |= 1u << (2 * f + e);
        }
      }
    }
    while (__any_sync(FULL, (pend[0] | pend[1]) != 0u)) {
      int total[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = __popc(pend[h]);
        int incl = c;
        int o = __shfl_up_sync(FULL, incl, 1, 4);
        if (t >= 1) incl += o;
        o = __shfl_up_sync(FULL, incl, 2, 4);
        if (t >= 2) incl += o;
        total[h] = __shfl_sync(FULL, incl, 3, 4);
        int slot = incl - c;
        const int r = wrow + g + 8 * h;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const unsigned bit = 1u << (2 * f + e);
            if (pend[h] & bit) {
              if (slot < CAP) {
                const float v2 = __int_as_float(acc[f][2 * h + e]);
                cand_d[r * CAPS + slot] = euclidean ? __fsqrt_rn(v2) : v2;
                cand_i[r * CAPS + slot] = col0 + 8 * f + 2 * t + e;
                pend[h] &= ~bit;
              }
              ++slot;
            }
          }
        }
      }
      // row wrow + r's count sits in lane 4 (r % 8), half r / 8
      const int lo = __shfl_sync(FULL, total[0], 4 * (lane & 7));
      const int hi = __shfl_sync(FULL, total[1], 4 * (lane & 7));
      const int cnt = min(lane < 8 ? lo : hi, CAP);
      __syncwarp();
      if constexpr (GLOBAL_LISTS) {
#pragma unroll 1
        for (int r = 0; r < WROWS; ++r) {
          const int c = __shfl_sync(FULL, cnt, r);
          const int row = wrow + r;
          for (int e = 0; e < c; ++e)
            rt::warp_insert_sorted(bd + row * ld, bi + row * ld, k, cand_d[row * CAPS + e],
                                   cand_i[row * CAPS + e], lane);
        }
      } else {
        const bool heavy = lane < WROWS && cnt >= MERGE_MIN;
        if (lane < WROWS && !heavy) {
          const int row = wrow + lane;
          for (int e = 0; e < cnt; ++e)
            insert_sorted_chunked(bd + row * ld, bi + row * ld, k, cand_d[row * CAPS + e],
                                  cand_i[row * CAPS + e]);
        }
        __syncwarp();
        for (unsigned rows = __ballot_sync(FULL, heavy); rows != 0u; rows &= rows - 1) {
          const int r = __ffs(rows) - 1;
          const int c = __shfl_sync(FULL, cnt, r);
          const int row = wrow + r;
          const bool has = lane < c;
          warp_merge(bd + row * ld, bi + row * ld, k, c,
                     has ? cand_d[row * CAPS + lane] : INFINITY,
                     has ? cand_i[row * CAPS + lane] : INT_MAX, lane);
        }
      }
      __syncwarp();
      if (owner) {
        const float was = kth;
        kth = bd[(wrow + lane) * ld + k - 1];
        if (bound != nullptr && kth < was && kth < gb) {
          atomicMin(reinterpret_cast<int*>(bound + orow), __float_as_int(kth));
          gb = kth;
        }
      }
      {
        const float own = euclidean ? sq_bound(fminf(kth, gb)) : fminf(kth, gb);
        t2[0] = __shfl_sync(FULL, own, g);
        t2[1] = __shfl_sync(FULL, own, g + 8);
      }
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (!(__int_as_float(acc[f][2 * h + e]) <= t2[h])) pend[h] &= ~(1u << (2 * f + e));
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][e] = 0;
    col0 += BN;
  }
  cp_wait<0>();

  if constexpr (!GLOBAL_LISTS) {
#pragma unroll 1
    for (int i = 0; i < WROWS; ++i) {
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

struct Args {
  const signed char* xq;
  const signed char* codes;
  const float* alpha;
  const float* xn;
  const float* sqnorms;
  const unsigned char* valid;
  float* list_d;
  int* list_i;
  float* bound;
  int m, n, d, k, euclidean, rows, splits, cols_per_split, copy;
};

template <bool GLOBAL_LISTS, bool VEC>
int launch_scan(const Args& a, cudaStream_t stream) {
  auto kernel = topk_int8_kernel<GLOBAL_LISTS, VEC>;
  const size_t smem = smem_bytes(a.rows, a.k, GLOBAL_LISTS);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.m + a.rows - 1) / a.rows, a.splits);
  kernel<<<grid, a.rows / WROWS * 32, smem, stream>>>(
      a.xq, a.codes, a.alpha, a.xn, a.sqnorms, a.valid, a.list_d, a.list_i, a.bound, a.m,
      a.n, a.d,
      a.k, a.euclidean, a.copy, a.cols_per_split);
  return static_cast<int>(cudaGetLastError());
}

bool bad_rows(int rows) {
  return rows < WROWS || rows % WROWS != 0 || rows / WROWS * 32 > MAX_THREADS;
}

}  // namespace


// Blocks of the scan that one SM holds at once for this k and strip
// height: kernels/topk/topk.py:split_plan sizes the grid by it.
extern "C" int topk_int8_blocks_per_sm(int k, int rows, int* blocks) {
  if (k < 1 || bad_rows(rows)) return static_cast<int>(cudaErrorInvalidValue);
  const bool global_lists = k > rt::SEL_SMEM_MAX_K;
  auto kernel = global_lists ? topk_int8_kernel<true, true> : topk_int8_kernel<false, true>;
  const size_t smem = smem_bytes(rows, k, global_lists);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, rows / WROWS * 32,
                                                        smem);
  return static_cast<int>(err);
}

// rows: query rows per block (a multiple of 16, at most 128).  part_d /
// part_i: (m, splits, k) scratch and bound: (m,) f32 of +inf when
// splits > 1 (null otherwise).  Split
// s scans columns [s * cols_per_split, (s + 1) * cols_per_split) of n.
// copy: 16 where d % 16 == 0 and xq, codes are 16-byte aligned, 4 where
// d % 4 == 0 and they are 4-byte aligned, else 1.
extern "C" int topk_int8(const signed char* xq, const signed char* codes, const float* alpha,
                         const float* xn, const float* sqnorms, const unsigned char* valid,
                         float* out_d, int* out_i, float* part_d, int* part_i, float* bound,
                         int m, int n,
                         int d, int k, int euclidean, int rows, int splits,
                         int cols_per_split, int copy, void* stream) {
  if (k < 1 || m < 1 || bad_rows(rows) || splits < 1 || splits > rt::MAX_SPLITS ||
      (splits > 1 && (part_d == nullptr || part_i == nullptr || bound == nullptr)) ||
      cols_per_split < 1 ||
      (long long)splits * cols_per_split < n ||
      (copy != COPY_BYTES && copy != COPY_WORDS && copy != COPY_CHUNKS))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{xq, codes, alpha, xn, sqnorms, valid,
               splits > 1 ? part_d : out_d, splits > 1 ? part_i : out_i,
               splits > 1 ? bound : nullptr,
               m, n, d, k, euclidean, rows, splits, cols_per_split, copy};
  const bool vec = copy == COPY_CHUNKS;
  int err;
  if (k > rt::SEL_SMEM_MAX_K) {
    err = vec ? launch_scan<true, true>(a, s) : launch_scan<true, false>(a, s);
  } else {
    err = vec ? launch_scan<false, true>(a, s) : launch_scan<false, false>(a, s);
  }
  if (err != 0 || splits == 1) return err;
  return topk_merge(part_d, part_i, out_d, out_i, m, splits, k, stream);
}
