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
// is CUDA-core work: two f32 instructions per (i, j, k) in every mode —
// the combine (or, in logminplus, the max that decides a skip) and the
// min — so 2*m*n*kd instructions (2048^3: 17.2 G, ~0.51 ms at 33.5 T
// instructions/s, the 67 TFLOP/s f32 peak counted one instruction per
// lane).  minmax's two are both FMNMX (min, max), and its loop, the same
// as minplus's, reads ~1.15 ms at 2048^3 against minplus's ~0.74: FMNMX
// seems to issue at half the FADD rate, see PERF.md.  Evaluating every
// logaddexp would cost exp and log1p on the
// special-function units (~4.1 ms at 2048^3); the skip below shows that
// work is not needed.  Traffic is (m*kd + kd*n + m*n) words, ~50 MB at
// 2048^3: far below either.
//
// Design.  The first design (one 64 x 64 tile per block, 4 x 4 register
// tiles fed by two float4 shared reads per 16 combines, slices stored
// element by element behind two barriers each, every logaddexp evaluated)
// read 1.390 / 1.134 / 9.931 ms (minmax / minplus / logminplus, 2048^3,
// NVIDIA H100 80GB HBM3, 700 W).
//
// - Tiles: 256 threads (8 warps) per block, one output tile and k range a
//   block.  The warps form a 4 x 2 grid; a lane owns rows r + 4 i and
//   columns c + 32 h + e (e < 4) of its warp's tile, a T x T register
//   tile: 8 x 8 (128 x 128 blocks) for minmax and minplus, 4 x 4 (64 x 64
//   blocks, three per SM) for logminplus, whose exp / log1p chains need
//   the warps to hide their latency.  Per 4 steps of k a thread reads T
//   float4 of A (rows of A are contiguous along k; a quarter-warp shares
//   each) and T float4 of B (rows of B are contiguous along n; a
//   quarter-warp reads 128 consecutive bytes) for 4 T^2 combines.  B is
//   general: no symmetry is assumed.
// - Copies: slices of 32 k pass global -> shared by cp.async (16-byte
//   chunks where kd % 4 == 0, n % 4 == 0 and the bases are aligned, 4-byte
//   elements otherwise) in a ring of 3 stages, one barrier per stage.  A is
//   stored k-major with a stride of 36 floats (the 4 rows a warp reads at
//   once fall on distinct banks), B as it lies.  The copies zero-fill past
//   the k range, and 0 is a real value in every mode, so the range's last
//   stage overwrites its k tail with +inf behind one more barrier.  Rows
//   past m and columns past n are never written, so their fill is moot.
// - Splits: kernels/qpath/qpath.py:split_plan cuts k into ranges of whole
//   stages where the output tiles are few (the bench config's 512^3
//   sweeps), and, for logminplus, finer still, since its work per tile
//   follows the data (clustered or banded graphs put most of it in a few
//   tiles).  The blocks write (splits, m, n) partial minima and
//   min_splits_kernel takes their min.  min is exact, so a split changes
//   no bit.
// - logminplus: the exact skip.  combine(a, b) = max(a, b) +
//   log1p(exp(-|a - b|)) is >= max(a, b) (the log1p term is >= 0 and a
//   round-to-nearest sum of x and a non-negative number is >= x; the a + b
//   branch for a - b NaN equals max(a, b) or is NaN, which fminf ignores),
//   so a triple with max(a, b) >= the running minimum cannot lower it, and
//   a row whose a is at least every minimum of the row is passed over
//   whole.  The SFUs cost a warp instruction whatever its active mask, so
//   a per-lane branch would save nothing: each thread marks, per step of
//   k, the elements of its tile whose max is below their minimum (a 16-bit
//   mask) and evaluates only those, in a loop over the set bits, so the warp
//   pays for the most that one lane needs.  An evaluated value lowers the
//   element's slot in shared memory (pend: a register tile cannot be
//   indexed at run time), and the registers take the slots' minima after
//   every 4 steps of k that lowered one; until then the test compares
//   against a minimum that may be stale, i.e. too high, which evaluates
//   more triples and skips none that matter.  Where some lane of a warp
//   has more than DENSE survivors in a step (dense operands, where the max
//   bound is weak), the warp evaluates its whole tiles straight through,
//   as the unpruned kernel does, into the registers.  The result is
//   bit-identical to evaluating every triple (tools/profile_qpath.py builds
//   that variant, SKIP = false, holds the two to each other and counts the
//   combines evaluated).  logaddexp reproduces jnp.logaddexp at +-inf:
//   when a - b is NaN (both infinite with the same sign) the result is
//   a + b, which keeps (-inf, -inf) -> -inf on the diagonal of the
//   log-domain edge matrix.
// - minmax has no skip: the same row skip (max(a, b) >= a) read 0.71
//   against 1.16 ms on the full-width build's sparse first sweep but 1.26
//   to 1.39 against 1.15 on its dense later ones, 7.02 against 6.94 ms over
//   the build's six (tools/profile_qpath.py, NVIDIA H100 80GB HBM3,
//   700 W), so minmax runs minplus's plain loop.
//
// Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): on the
// fixed 2048^3 first / last sweep's operand minmax 1.148 / 1.152 ms,
// minplus 0.7320 / 0.7479 ms, logminplus 1.455 / 3.744 ms with 0.027 % /
// 1.37 % of the combines evaluated (tools/profile_qpath.py); on the sweeps
// the builds run, a mean of 1.161 ms (minmax, full width, 2048^3), 0.300
// ms (logminplus, bench config q=2, 512^3) and 1.841 ms (logminplus,
// infinity retrieval, 1000^3).  PERF.md has every row.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 32;       // k per pipeline stage (qpath.py:STAGE_K)
constexpr int LDA = BK + 4;  // shared row stride of A, floats
constexpr int STAGES = 3;
// logminplus evaluates combine only where max(a, b) is below the minimum
constexpr bool SKIP = true;
// a step of k where some lane of a warp has more survivors than this is
// evaluated whole, every element of every lane's tile
constexpr int DENSE = 4;

// Must match repro_torch/kernels/qpath/qpath.py:MODE_CODES.
enum Mode : int { MINPLUS = 0, MINMAX = 1, LOGMINPLUS = 2 };

__host__ __device__ constexpr bool pruned(int mode) { return mode == LOGMINPLUS && SKIP; }

// The register tile of a thread, T x T: rows r + 4 i and columns
// c + 32 (j / 4) + j % 4 of its warp's tile.  The warps form a 4 x 2 grid,
// so a block's output tile is 16 T x 16 T (qpath.py:TILE).  logminplus
// takes 4 x 4 tiles: more blocks per SM to hide the latency of its
// exp / log1p chains.
__host__ __device__ constexpr int tile(int mode) { return mode == LOGMINPLUS ? 4 : 8; }

template <int MODE>
constexpr size_t smem_bytes() {
  constexpr int T = tile(MODE);
  return sizeof(float) * (STAGES * 16 * T * (LDA + BK) + (pruned(MODE) ? T * T * THREADS : 0));
}

template <int MODE>
__device__ __forceinline__ float combine(float a, float b) {
  if (MODE == MINPLUS) return a + b;
  if (MODE == MINMAX) return fmaxf(a, b);
  const float delta = a - b;
  return isnan(delta) ? a + b : fmaxf(a, b) + log1pf(expf(-fabsf(delta)));
}

// v.x, v.y, v.z or v.w (s is a constant wherever the loops unroll).
__device__ __forceinline__ float component(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// Rows [k0, k0 + BK) x columns [c0, c0 + BN) of B (kd x n) into dst
// (BK x BN), zero past row kend and column n.
template <int BN, bool VEC>
__device__ __forceinline__ void load_cols(float* dst, const float* B, int k0, int kend,
                                          int c0, int n, int tid) {
  if constexpr (VEC) {
    constexpr int CH = BN / 4;
#pragma unroll
    for (int e = tid; e < BK * CH; e += THREADS) {
      const int r = e / CH;
      const int c = (e % CH) * 4;
      const bool ok = k0 + r < kend && c0 + c < n;
      rt::cp_async16(dst + r * BN + c, ok ? B + (size_t)(k0 + r) * n + c0 + c : B, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const bool ok = k0 + r < kend && c0 + c < n;
      rt::cp_async4(dst + e, ok ? B + (size_t)(k0 + r) * n + c0 + c : B, ok);
    }
  }
}

// The block's (m, n) tile over k in [z * k_per_split, (z + 1) * k_per_split)
// for z = blockIdx.z, into C + z * m * n.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS, MODE == LOGMINPLUS ? 3 : 2)
    qpath_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int m, int kd, int n, int k_per_split) {
  constexpr int TM = tile(MODE);
  constexpr int TN = TM;
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  static_assert(!pruned(MODE) || TM * TN <= 32, "a thread's survivors are one mask word");
  extern __shared__ __align__(16) float smem[];
  float* as_ring = smem;                         // [STAGES][BM][LDA]
  float* bs_ring = as_ring + STAGES * BM * LDA;  // [STAGES][BK][BN]
  float* pend = bs_ring + STAGES * BK * BN;      // [TM * TN][THREADS], pruned only

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tr = (warp / 2) * 4 * TM + lane / 8;        // rows tr + 4 i of the tile
  const int tc = (warp % 2) * 8 * TN + 4 * (lane % 8);  // columns tc + 32 h + e
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(kd, kbeg + k_per_split);
  const int nk = (kend - kbeg + BK - 1) / BK;
  C += (size_t)blockIdx.z * m * n;

  auto load_stage = [&](int g) {
    const int slot = g % STAGES;
    const int k0 = kbeg + g * BK;
    rt::load_rows<BM, BK, LDA, THREADS, VEC>(as_ring + slot * BM * LDA, A, row0, m, k0, kend,
                                             kd, tid);
    load_cols<BN, VEC>(bs_ring + slot * BK * BN, B, k0, kend, col0, n, tid);
  };

#pragma unroll
  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < nk) load_stage(g);
    rt::cp_commit();
  }

  float acc[TM][TN];
  // logminplus: the largest minimum of each row, as of the last fold
  // below; where a >= rmax, max(a, b) >= every minimum of the row and the
  // whole row is skipped (a stale, i.e. higher, rmax only skips less)
  float rmax[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rmax[i] = INFINITY;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = INFINITY;
  }
  // logminplus: a survivor's combine lowers its element's slot in pend,
  // a dense step's lower the registers; the minimum is the min of the two,
  // and the registers take it after every 4 steps of k that lowered a slot
  bool dirty = false;
  if constexpr (pruned(MODE)) {
#pragma unroll
    for (int e = 0; e < TM * TN; ++e) pend[e * THREADS + tid] = INFINITY;
  }

  for (int g = 0; g < nk; ++g) {
    rt::cp_wait<STAGES - 2>();
    __syncthreads();  // stage g landed; every warp is done with stage g - 1
    if (g + STAGES - 1 < nk) load_stage(g + STAGES - 1);
    rt::cp_commit();

    float* as = as_ring + (g % STAGES) * BM * LDA;
    float* bs = bs_ring + (g % STAGES) * BK * BN;
    const int live = kend - (kbeg + g * BK);  // k of this stage inside the range
    if (live < BK) {
      for (int e = tid; e < BM * BK; e += THREADS)
        if (e % BK >= live) as[(e / BK) * LDA + e % BK] = INFINITY;
      for (int e = live * BN + tid; e < BK * BN; e += THREADS) bs[e] = INFINITY;
      __syncthreads();
    }
    const float* ap = as + tr * LDA;
    const float* bp = bs + tc;

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(ap + 4 * i * LDA + kk);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = kk + s;
        float b[TN];
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(bp + k * BN + 32 * h);
          b[4 * h] = v.x;
          b[4 * h + 1] = v.y;
          b[4 * h + 2] = v.z;
          b[4 * h + 3] = v.w;
        }
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = component(a4[i], s);
        if constexpr (pruned(MODE)) {
          // bit TN i + j: element (i, j)'s max is below its minimum, so its
          // combine may lower it
          unsigned bits = 0;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (a[i] >= rmax[i]) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j)
              if (fmaxf(a[i], b[j]) < acc[i][j]) bits |= 1u << (i * TN + j);
          }
          if (__any_sync(0xffffffffu, __popc(bits) > DENSE)) {
            // a dense step: the whole tile, as the unpruned kernel does
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fminf(acc[i][j], combine<MODE>(a[i], b[j]));
          } else {
            dirty |= bits != 0;
            while (bits) {
              const int e = __ffs(bits) - 1;
              bits &= bits - 1;
              const float c = combine<MODE>(ap[4 * (e / TN) * LDA + k],
                                            bp[k * BN + 32 * (e % TN / 4) + e % 4]);
              float* p = pend + e * THREADS + tid;
              *p = fminf(*p, c);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fminf(acc[i][j], combine<MODE>(a[i], b[j]));
        }
      }
      if constexpr (pruned(MODE)) {
        // the registers catch up with pend after every 4 steps of k that
        // lowered a slot
        if (dirty) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fminf(acc[i][j], pend[(i * TN + j) * THREADS + tid]);
            rmax[i] = acc[i][0];
#pragma unroll
            for (int j = 1; j < TN; ++j) rmax[i] = fmaxf(rmax[i], acc[i][j]);
          }
          dirty = false;
        }
      }
    }
  }
  rt::cp_wait<0>();

  const bool vec_out = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + tr + 4 * i;
    if (gr >= m) break;
    float* crow = C + (size_t)gr * n;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int gc = col0 + tc + 32 * h;
      if (vec_out) {
        if (gc < n)
          *reinterpret_cast<float4*>(crow + gc) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < n) crow[gc + e] = acc[i][4 * h + e];
      }
    }
  }
}

// C = the elementwise min of the splits' partial products part (S, mn).
__global__ void __launch_bounds__(THREADS)
    min_splits_kernel(const float* __restrict__ part, float* __restrict__ C, int S,
                      size_t mn) {
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < mn;
       e += (size_t)gridDim.x * THREADS) {
    float v = part[e];
    for (int s = 1; s < S; ++s) v = fminf(v, part[s * mn + e]);
    C[e] = v;
  }
}

template <int MODE, bool VEC>
int launch(const float* A, const float* B, float* C, int m, int kd, int n, int splits,
           int k_per_split, cudaStream_t s) {
  auto kernel = qpath_kernel<MODE, VEC>;
  constexpr size_t smem = smem_bytes<MODE>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BT = 16 * tile(MODE);
  const dim3 grid((n + BT - 1) / BT, (m + BT - 1) / BT, splits);
  kernel<<<grid, THREADS, smem, s>>>(A, B, C, m, kd, n, k_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_mode(const float* A, const float* B, float* C, int m, int kd, int n, int splits,
                int k_per_split, bool vec, cudaStream_t s) {
  return vec ? launch<MODE, true>(A, B, C, m, kd, n, splits, k_per_split, s)
             : launch<MODE, false>(A, B, C, m, kd, n, splits, k_per_split, s);
}

template <int MODE>
int resident(int* blocks) {
  auto kernel = qpath_kernel<MODE, true>;
  constexpr size_t smem = smem_bytes<MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  return static_cast<int>(err);
}

}  // namespace

// Blocks of the kernel that one SM holds at once in this mode:
// kernels/qpath/qpath.py:split_plan sizes the splits by it.
extern "C" int qpath_blocks_per_sm(int mode, int* blocks) {
  switch (mode) {
    case MINPLUS:
      return resident<MINPLUS>(blocks);
    case MINMAX:
      return resident<MINMAX>(blocks);
    case LOGMINPLUS:
      return resident<LOGMINPLUS>(blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Split z covers k in [z * k_per_split, min(kd, (z + 1) * k_per_split));
// every split is non-empty and k_per_split is a multiple of the stage.
// part: (splits, m, n) scratch when splits > 1 (null otherwise).  aligned:
// kd % 4 == 0, n % 4 == 0 and A, B 16-byte aligned.
extern "C" int qpath_f32(const float* A, const float* B, float* C, float* part, int m,
                         int kd, int n, int mode, int splits, int k_per_split, int aligned,
                         void* stream) {
  if (m < 1 || n < 1 || kd < 1 || splits < 1 || k_per_split < 1 || k_per_split % BK != 0 ||
      (long long)splits * k_per_split < kd || (long long)(splits - 1) * k_per_split >= kd ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = splits > 1 ? part : C;
  const bool vec = aligned != 0;
  int err;
  switch (mode) {
    case MINPLUS:
      err = launch_mode<MINPLUS>(A, B, out, m, kd, n, splits, k_per_split, vec, s);
      break;
    case MINMAX:
      err = launch_mode<MINMAX>(A, B, out, m, kd, n, splits, k_per_split, vec, s);
      break;
    case LOGMINPLUS:
      err = launch_mode<LOGMINPLUS>(A, B, out, m, kd, n, splits, k_per_split, vec, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0 || splits == 1) return err;
  const size_t mn = (size_t)m * n;
  const size_t want = (mn + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  min_splits_kernel<<<blocks, THREADS, 0, s>>>(part, C, splits, mn);
  return static_cast<int>(cudaGetLastError());
}
