// Exact re-score of gathered candidate lists, a batch in one launch, one
// block a query (core/scan.topk_candidates on the card; plain version:
// core/scan.py:_select_candidates over the gathered rows).
//
// It replaces no TPU kernel.  The JAX package's topk_candidates
// (src/repro/core/scan.py:241) is jnp under vmap, which XLA fuses; the
// eager port gathered a (B, C, d) f32 block a chunk of queries at a time,
// ran the pair form as three ATen passes over it and a stable sort of C a
// row: ~7 passes over ~6.6 GB for the live cell's 512 x 4 096 x 784
// oversample, ~17 ms a batch.
//
// Bound.  The pair form is about two f32 instructions an element, ~0.4
// flop a byte of the rows the lists name: far under the card's ridge.  The
// live cell's 512 lists of ~3 900 alive rows of 784 floats are ~6.3 GB if
// every list's rows come from device memory (1.88 ms at 3.35 TB/s), but
// they name only ~57 000 distinct rows (179 MB, 0.05 ms), each in ~35
// lists; then the ~3.1 G instructions (0.094 ms at 33.5 T/s) bound it.
// What the kernel meets is the traffic between L2 and the SMs, so the
// design spends nothing on arithmetic and everything on keeping loads in
// flight and on serving the repeats from L2:
//
// - One block of 8 warps a query, the query row in shared memory.  A warp
//   scores one candidate row at a time: each lane reads its share of the
//   row as 16-byte loads (d % 4 == 0 and X 16-byte aligned; 4-byte loads
//   otherwise), all issued before any is used, up to UNROLL a lane: a
//   784-float row's 196 float4 in one round.  A warp takes 32 candidates
//   at a time, their ids read by one load and passed by shuffle, so no row
//   load waits on its own id load.  At 4 blocks an SM (64 registers a
//   thread), 32 warps an SM keep ~100 KB of rows in flight, and a batch of
//   512 queries is one wave on 132 SMs.
// - The visiting order: a block scores its alive candidates by the bin of
//   their id (BINS ranges of ids, a counting sort in shared memory), not
//   in list order.  The blocks of a wave start together and move at about
//   the same pace, so they sweep X from its first rows to its last
//   together, and a row several lists name is read once from device
//   memory and then from L2.  At the live cell's shapes this took the
//   kernel from 1.59 to 0.875 ms (NVIDIA H100 80GB HBM3, 700 W).
// - The distances stay on the chip: C floats of shared memory up to
//   DIST_SMEM candidates (16 KB at C = 4 096), with the visiting order;
//   past it a (B, 2C) scratch that only the block reads back, from L2.  A
//   -1 candidate, or any id outside [0, n), scores +inf and loads nothing.
// - Selection: the min(k, C) smallest by (distance, position), ties to the
//   earlier position, NaN after +inf: torch.sort's stable order.  A radix
//   select over order-preserving u32 keys (4 passes of 8 bits, warp-
//   aggregated shared atomics) finds the exact min(k, C)-th key T and how
//   many keys equal to T to keep; a compaction in position order keeps the
//   keys below T and the first of those equal to T; a bitonic network
//   orders the survivors as (key, position) words, in shared memory up to
//   SORT_WORDS of them, in a (B, min(k, C)) scratch above.  At k = 10 the
//   selection is a few microseconds a block.
// - Each row's sum is one warp's, in a fixed order, and each query one
//   block's, so a query's answer does not depend on the queries it shares
//   a call with, nor on the order the block visits its rows in.  The work
//   split is one block a query at every C: at C = 256 (the infinity
//   rerank) a warp scores 32 rows, at C = 4 096 (the live oversample) ~490.
//
// The score is the metric's pair form (core/metrics.py), never the matmul
// expansion |q|^2 + |x|^2 - 2 q.x: sum (q - x)^2 (its sqrt for euclidean),
// sum |q - x|, max |q - x|, -q.x, and 1 - q.x / max(|q| |x|, EPS).  The
// f32 sums run in another order than ATen's, so the tests hold the kernel
// to the repo's f32 tolerance, not to bit-equality with the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;  // radix digits a pass (8 bits), one a thread
constexpr int UNROLL = 8;  // loads in flight a lane, a row
// Must match kernels/rescore/rescore.py.
constexpr int DIST_SMEM = 8192;   // candidates whose distances sit in shared memory
constexpr int SORT_WORDS = 4096;  // survivors sorted in shared memory
constexpr int MAX_DIM = 16384;    // query floats in shared memory

static_assert(BINS == THREADS, "one radix bin a thread");

// How a row's score accumulates over d.
enum Form : int { SQ = 0, ABS_SUM = 1, ABS_MAX = 2, DOT = 3, COS = 4 };

// Where a block keeps its query, distances and survivors (dynamic shared
// memory, or the wrapper's scratch); the same on the host and the card.
struct Layout {
  int want;           // min(k, C): the survivors
  int qfloats;        // the query, padded to 16 bytes
  bool dist_shared;   // C <= DIST_SMEM: the distances and the visiting order
  bool words_shared;  // want <= SORT_WORDS
  size_t words_off;   // bytes
  size_t bytes;       // dynamic shared memory
};

__host__ __device__ inline Layout layout(int d, int C, int k) {
  Layout L;
  L.want = k < C ? k : C;
  L.qfloats = (d + 3) & ~3;
  L.dist_shared = C <= DIST_SMEM;
  L.words_shared = L.want <= SORT_WORDS;
  const size_t off = 4 * (size_t)(L.qfloats + (L.dist_shared ? 2 * (size_t)C : 0));
  L.words_off = (off + 7) & ~(size_t)7;
  L.bytes = L.words_off + (L.words_shared ? 8 * (size_t)L.want : 0);
  return L;
}

template <int F>
__device__ __forceinline__ void accumulate(float& a, float& b, float q, float x) {
  if constexpr (F == SQ) {
    const float t = q - x;
    a = fmaf(t, t, a);
  } else if constexpr (F == ABS_SUM) {
    a += fabsf(q - x);
  } else if constexpr (F == ABS_MAX) {
    a = fmaxf(a, fabsf(q - x));
  } else if constexpr (F == DOT) {
    a = fmaf(q, x, a);
  } else {
    a = fmaf(q, x, a);
    b = fmaf(x, x, b);
  }
}

// The pair-form score of row x against the shared query, by the whole warp
// (warp-uniform arguments); every lane returns it.
template <int F, bool VEC>
__device__ __forceinline__ float score_row(const float* __restrict__ qs,
                                           const float* __restrict__ x, int d, int lane,
                                           float qnorm, bool root) {
  float a = 0.0f, b = 0.0f;
  if constexpr (VEC) {
    const int d4 = d >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int c0 = 0; c0 < d4; c0 += 32 * UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        v[u] = c < d4 ? __ldg(x4 + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < d4) {
          const float4 q = q4[c];
          accumulate<F>(a, b, q.x, v[u].x);
          accumulate<F>(a, b, q.y, v[u].y);
          accumulate<F>(a, b, q.z, v[u].z);
          accumulate<F>(a, b, q.w, v[u].w);
        }
      }
    }
  } else {
    for (int c0 = 0; c0 < d; c0 += 32 * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        v[u] = c < d ? __ldg(x + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < d) accumulate<F>(a, b, qs[c], v[u]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, a, off);
    a = F == ABS_MAX ? fmaxf(a, o) : a + o;
    if constexpr (F == COS) b += __shfl_xor_sync(FULL, b, off);
  }
  if constexpr (F == SQ) return root ? sqrtf(fmaxf(a, 0.0f)) : a;
  if constexpr (F == DOT) return -a;
  if constexpr (F == COS) return 1.0f - a / fmaxf(qnorm * sqrtf(b), rt::EPS);
  return a;
}

// u32 keys in the order of torch.sort: -0 taken as +0 (the two tie), every
// NaN after +inf.
__device__ __forceinline__ unsigned sort_key(float v) {
  if (isnan(v)) return FULL;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long word(unsigned key, int pos) {
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(pos);
}

// hist[digit] += 1 for each lane with `on`, one shared atomic per distinct
// digit of the warp (a list's distances crowd into few top digits).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, bool on, int lane) {
  const unsigned peers = __match_any_sync(FULL, on ? digit : FULL);
  if (on && lane == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
}

// The exclusive prefix sum of h over the block's threads in thread order;
// *total gets the sum of all.  Two barriers; `sums` holds WARPS words.
__device__ __forceinline__ unsigned block_exclusive(unsigned h, unsigned* sums,
                                                    unsigned* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  unsigned incl = h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < WARPS ? sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += t;
    }
    if (lane < WARPS) sums[lane] = s;
  }
  __syncthreads();
  *total = sums[WARPS - 1];
  return (warp ? sums[warp - 1] : 0u) + incl - h;
}

// The bin of id c (0 <= c < n): BINS ranges of ids in ascending order.
__device__ __forceinline__ unsigned id_bin(long long c, int n) {
  return static_cast<unsigned>(c * BINS / n);
}

// One step of the ascending bitonic network over w[0, cnt), entries past
// cnt taken as +inf: `flip` pairs i with its mirror in its block of
// `size`, else with i + stride; the smaller word goes to i.  A pair with
// j >= cnt keeps its order, so no padding is stored.
__device__ __forceinline__ void bitonic_step(unsigned long long* w, int cnt, int size,
                                             int stride, bool flip) {
  const int half = flip ? size / 2 : stride;
  for (int t = threadIdx.x;; t += THREADS) {
    const int i = (t / half) * 2 * half + t % half;
    if (i >= cnt) break;
    const int j = flip ? (i ^ (size - 1)) : i + half;
    if (j < cnt) {
      const unsigned long long a = w[i], b = w[j];
      if (b < a) {
        w[i] = b;
        w[j] = a;
      }
    }
  }
  __syncthreads();
}

template <int F, bool VEC, typename Id>
__global__ void __launch_bounds__(THREADS, 4)
    rescore_kernel(const float* __restrict__ Q, const Id* __restrict__ cand,
                   const float* __restrict__ X, float* __restrict__ out_d,
                   int* __restrict__ out_i, float* __restrict__ dist_scratch,
                   unsigned long long* __restrict__ word_scratch, int n, int d, int C,
                   int k, int root) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[BINS];
  __shared__ unsigned sums[2 * WARPS];
  __shared__ unsigned sel[2];
  __shared__ float qnorm;
  const Layout L = layout(d, C, k);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  float* qs = reinterpret_cast<float*>(smem);
  float* dist = L.dist_shared ? qs + L.qfloats : dist_scratch + (size_t)b * 2 * C;
  unsigned* order = reinterpret_cast<unsigned*>(dist + C);
  unsigned long long* words =
      L.words_shared ? reinterpret_cast<unsigned long long*>(smem + L.words_off)
                     : word_scratch + (size_t)b * L.want;
  const Id* cb = cand + (size_t)b * C;

  for (int i = tid; i < d; i += THREADS) qs[i] = Q[(size_t)b * d + i];
  __syncthreads();
  if constexpr (F == COS) {
    if (warp == 0) {
      float s = 0.0f;
      for (int i = lane; i < d; i += 32) s = fmaf(qs[i], qs[i], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) qnorm = sqrtf(s);
    }
    __syncthreads();
  }
  const float qn = F == COS ? qnorm : 0.0f;

  // The visiting order: the alive positions by the bin of their id (a
  // counting sort; within a bin in no set order), so that the blocks of a
  // batch, which start together, sweep X from its first rows to its last
  // together and a row several lists share is read from L2.  The rest
  // score +inf here.
  unsigned alive;
  hist[tid] = 0;
  __syncthreads();
  for (int i = tid; i < C; i += THREADS) {
    const long long c = static_cast<long long>(cb[i]);
    if (c >= 0 && c < n) {
      atomicAdd(hist + id_bin(c, n), 1u);
    } else {
      dist[i] = INFINITY;
    }
  }
  __syncthreads();
  const unsigned first = block_exclusive(hist[tid], sums, &alive);
  hist[tid] = first;
  __syncthreads();
  for (int i = tid; i < C; i += THREADS) {
    const long long c = static_cast<long long>(cb[i]);
    if (c >= 0 && c < n) order[atomicAdd(hist + id_bin(c, n), 1u)] = static_cast<unsigned>(i);
  }
  __syncthreads();

  // Scores: warp w takes the order's entries [32 (w + WARPS t), +32).
  for (int base = warp * 32; base < static_cast<int>(alive); base += THREADS) {
    int pos = -1, id = -1;
    if (base + lane < static_cast<int>(alive)) {
      pos = static_cast<int>(order[base + lane]);
      id = static_cast<int>(cb[pos]);
    }
    const int rows = min(32, static_cast<int>(alive) - base);
    for (int j = 0; j < rows; ++j) {
      const int r = __shfl_sync(FULL, id, j);
      const float v = score_row<F, VEC>(qs, X + (size_t)r * d, d, lane, qn, root != 0);
      if (lane == j) dist[pos] = v;
    }
  }
  __syncthreads();

  // The want-th smallest key T, 8 bits a pass from the top; rem = its rank
  // among the keys that share the digits found so far.  want == C: all.
  const int want = L.want;
  const bool all = want >= C;
  unsigned T = FULL;
  int need = 0;
  if (!all) {
    unsigned prefix = 0, rem = static_cast<unsigned>(want);
#pragma unroll 1
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      const unsigned hi = pass == 0 ? 0u : (FULL << (shift + 8));
      hist[tid] = 0;
      __syncthreads();
      for (int base = 0; base < C; base += THREADS) {
        const int i = base + tid;
        const unsigned key = i < C ? sort_key(dist[i]) : 0u;
        hist_add(hist, (key >> shift) & 0xffu, i < C && (key & hi) == (prefix & hi), lane);
      }
      __syncthreads();
      const unsigned h = hist[tid];
      unsigned total;
      const unsigned below = block_exclusive(h, sums, &total);
      if (below < rem && rem <= below + h) {
        sel[0] = static_cast<unsigned>(tid);
        sel[1] = below;
      }
      __syncthreads();
      prefix |= sel[0] << shift;
      rem -= sel[1];
      __syncthreads();  // sel and hist are written again next pass
    }
    T = prefix;
    need = static_cast<int>(rem);
  }

  // Compaction in position order: every key below T and the first `need`
  // keys equal to T (all of them where all).  Ranks from two ballots and
  // the warps' counts (two buffers, so one barrier a tile).
  int taken = 0, eq_seen = 0;
  for (int base = 0, buf = 0; base < C; base += THREADS, buf ^= 1) {
    const int i = base + tid;
    const unsigned key = i < C ? sort_key(dist[i]) : FULL;
    const bool less = i < C && (all || key < T);
    const bool eq = i < C && !all && key == T;
    const unsigned bl = __ballot_sync(FULL, less);
    const unsigned be = __ballot_sync(FULL, eq);
    unsigned* ws = sums + buf * WARPS;  // low half: less, high: equal
    if (lane == 0) ws[warp] = __popc(bl) | (__popc(be) << 16);
    __syncthreads();
    int lb = 0, eb = 0, lt = 0, et = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned x = ws[w];
      if (w < warp) {
        lb += x & 0xffffu;
        eb += x >> 16;
      }
      lt += x & 0xffffu;
      et += x >> 16;
    }
    const unsigned lower = (1u << lane) - 1u;
    const int lrank = lb + __popc(bl & lower);
    const int erank = eb + __popc(be & lower);
    const int avail = max(0, need - eq_seen);
    if (less || (eq && erank < avail)) words[taken + lrank + min(erank, avail)] = word(key, i);
    taken += lt + min(et, avail);
    eq_seen += et;
  }
  __syncthreads();

  // Order the want survivors by (key, position).
  int n2 = 1;
  while (n2 < want) n2 <<= 1;
  for (int size = 2; size <= n2; size <<= 1) {
    bitonic_step(words, want, size, 0, true);
    for (int stride = size / 4; stride > 0; stride >>= 1)
      bitonic_step(words, want, size, stride, false);
  }

  float* od = out_d + (size_t)b * k;
  int* oi = out_i + (size_t)b * k;
  for (int e = tid; e < k; e += THREADS) {
    float v = INFINITY;
    int id = -1;
    if (e < want) {
      const int pos = static_cast<int>(words[e] & 0xffffffffu);
      v = dist[pos];
      if (!isinf(v)) id = static_cast<int>(cb[pos]);
    }
    od[e] = v;
    oi[e] = id;
  }
}

struct Args {
  const float* Q;
  const void* cand;
  const float* X;
  float* out_d;
  int* out_i;
  float* dist_scratch;
  unsigned long long* word_scratch;
  int B, C, n, d, k, root;
};

template <int F, bool VEC, typename Id>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = rescore_kernel<F, VEC, Id>;
  const Layout L = layout(a.d, a.C, a.k);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.B, THREADS, L.bytes, stream>>>(a.Q, static_cast<const Id*>(a.cand), a.X,
                                            a.out_d, a.out_i, a.dist_scratch,
                                            a.word_scratch, a.n, a.d, a.C, a.k, a.root);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_form(const Args& a, bool vec, bool id64, cudaStream_t s) {
  if (id64) return vec ? launch<F, true, long long>(a, s) : launch<F, false, long long>(a, s);
  return vec ? launch<F, true, int>(a, s) : launch<F, false, int>(a, s);
}

}  // namespace

// The k best of each of the B candidate lists cand (B, C) (int32, or int64
// where id64) over X (n, d) for the queries Q (B, d): out_d (B, k)
// ascending, out_i (B, k) int32, (+inf, -1) past the scored candidates.
// metric: common.cuh's rt::Metric.  aligned: d % 4 == 0 and X 16-byte
// aligned.  dist_scratch: (B, 2C) f32 where C > DIST_SMEM (each list's
// distances, then its visiting order as u32), else unused;
// word_scratch: (B, min(k, C)) u64 where min(k, C) > SORT_WORDS, else
// unused.
extern "C" int rescore(const float* Q, const void* cand, const float* X, float* out_d,
                       int* out_i, float* dist_scratch, unsigned long long* word_scratch,
                       int B, int C, int n, int d, int k, int metric, int id64, int aligned,
                       void* stream) {
  if (B < 0 || C < 0 || n < 0 || d < 1 || d > MAX_DIM || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(d, C, k);
  if ((!L.dist_shared && dist_scratch == nullptr) ||
      (!L.words_shared && word_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const Args a{Q, cand, X, out_d, out_i, dist_scratch, word_scratch,
               B, C, n, d, k, metric == rt::EUCLIDEAN};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned != 0, wide = id64 != 0;
  switch (metric) {
    case rt::SQEUCLIDEAN:
    case rt::EUCLIDEAN:
      return launch_form<SQ>(a, vec, wide, s);
    case rt::MANHATTAN:
      return launch_form<ABS_SUM>(a, vec, wide, s);
    case rt::CHEBYSHEV:
      return launch_form<ABS_MAX>(a, vec, wide, s);
    case rt::DOT:
      return launch_form<DOT>(a, vec, wide, s);
    case rt::COSINE:
      return launch_form<COS>(a, vec, wide, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
