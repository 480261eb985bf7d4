// The beam's level loop over a flattened VP tree, every level of a query
// batch in one launch, one block a query (core/vptree.search_beam's
// traversal; plain version: core/vptree.py:beam_levels).
//
// It replaces no TPU kernel.  The JAX package's beam
// (src/repro/core/vptree.py:_beam_impl) is jnp under jax.jit, which XLA
// compiles into one program; the eager port paid one launch for each of
// the loop's ~114 ATen ops a level, 1 368 a 12-level batch of 512 at
// 18-31 us of host each, while the card worked ~3 ms of the loop's 25-42.
//
// Bound.  A level reads, for each query, W vantage rows and up to 2W
// centroid rows of d floats and 24 bytes of node arrays a vantage: at
// W = 16, d = 32, ~6 KB a level, ~75 KB a query over 12 levels, ~39 MB a
// batch of 512, ~12 us at 3.35 TB/s, mostly from L2 (every query reads the
// tree's top).  What bounds it in practice is the latency of the dependent
// levels: a level's reads wait for the previous level's selection.  So a
// block of 8 warps keeps its query's whole state in shared memory (the
// query row, the best list, the bucket buffer, the frontier and the 2W
// children), a level's node-array reads go out with its row reads, the
// warps take the rows in parallel, and nothing goes through global memory
// between levels: no atomics.
//
// Sizes.  A level accepts at most W vantages and reaches at most 2W
// buckets, so at most W * depth entries of the best list and 2W * depth
// of the bucket buffer are ever finite: the block holds min(K, W * depth)
// and min(Bcap, 2W * depth) of them, takes tau = +inf where K is more than
// it holds (the K-th entry is then +inf in the plain version too), and
// pads the outputs with (+inf, -1).  The state of the b512 cells' plan
// (W 16, Bcap 32, K 256, d 32, depth 12) is ~5 KB a block.  No size is
// bounded: a block's state goes to global scratch (cudaMallocAsync on the
// launch's stream) where it passes the card's shared memory a block, and
// with 2W past the block's threads each thread takes several children.
//
// Semantics: the plain version's, to the letter.
// - The best list (K) and the bucket buffer (Bcap) stay sorted ascending.
//   A level's new entries are ordered by (value, slot) and merged after
//   the old entries they tie with: the plain version's stable sort of
//   old ++ new.  A new entry whose value is not finite never enters: the
//   best list always holds K entries, (+inf, -1) padding included, that
//   sort before it, and a buffer or frontier entry that is not finite
//   becomes -1.
// - The next frontier is the W smallest finite priorities of the 2W
//   children by (priority, position), the W in-children before the W
//   out-children; the rest -1, their bound 0.
// - Distances (vector mode) are euclidean, the sum of squared differences
//   split over a warp's lanes in the order of PyTorch's CUDA sum over a
//   contiguous last dimension (warp_dist; an order read off the card for
//   one torch build, so the tests hold the kernel to the f32 tolerance and
//   report bit-equality apart); the prune rules and priorities round each
//   operation as the plain version's tensor ops do (explicit _rn intrinsics, so nothing is contracted), and (x/s)^q is
//   x*x at q = 2, x*x*x at q = 3, x at q = 1, else powf, as ATen's pow.
//   Rows mode (X == nullptr) gathers the query's precomputed row through
//   perm and ranks buckets by priority.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum QMode : int { Q_INF = 0, Q_ONE = 1, Q_TWO = 2, Q_THREE = 3, Q_POW = 4 };

__device__ __forceinline__ float qpow(float x, float q, int mode) {
  switch (mode) {
    case Q_ONE: return x;
    case Q_TWO: return __fmul_rn(x, x);
    case Q_THREE: return __fmul_rn(__fmul_rn(x, x), x);
    default: return powf(x, q);
  }
}

__device__ __forceinline__ void sq_add(float& acc, const float* qs, const float* row, int c) {
  const float t = __fsub_rn(qs[c], __ldg(row + c));
  acc = __fadd_rn(acc, __fmul_rn(t, t));
}

// ||qs - row||, by the 32 lanes of a warp, every lane returning it, in the
// order of ATen's reduce kernel for a CUDA sum over a contiguous last
// dimension (read off the card: bit-equal at d = 6, 32, 100 and 256).  Up to
// d = 128: w = min(pow2floor(d), 32) lanes; lane l adds the squares of
// columns l + p*w into accumulator p % 4 in order of p.  Above, with d a
// multiple of 4, ATen loads 4 columns at a time: lane l adds columns
// 4l + 128j + i into accumulator i in order of j.  A lane's total is
// ((a0 + a1) + a2) + a3; the lanes' totals add as a tree, shfl_down by
// 16, 8, 4, 2, 1 (lanes past w hold 0).  Above d = 128 with d not a multiple
// of 4 ATen first aligns its loads, and the last bit may differ there.
__device__ __forceinline__ float warp_dist(const float* qs, const float* __restrict__ row,
                                           int d, int w, int lane) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (d > 128 && (d & 3) == 0) {
    for (int c = 4 * lane; c < d; c += 128) {
      sq_add(a0, qs, row, c);
      sq_add(a1, qs, row, c + 1);
      sq_add(a2, qs, row, c + 2);
      sq_add(a3, qs, row, c + 3);
    }
  } else if (lane < w) {
    for (int c = lane; c < d; c += 4 * w) {
      sq_add(a0, qs, row, c);
      if (c + w < d) sq_add(a1, qs, row, c + w);
      if (c + 2 * w < d) sq_add(a2, qs, row, c + 2 * w);
      if (c + 3 * w < d) sq_add(a3, qs, row, c + 3 * w);
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  s = __shfl_sync(0xffffffffu, s, 0);
  return __fsqrt_rn(fmaxf(s, 0.0f));
}

// The block's sum of v, every thread's v counted; `one`: no thread has more
// than one item (v is 0 or 1), so one __syncthreads_count does.  A barrier.
__device__ __forceinline__ int block_count(int v, bool one, int* red, int lane, int warp) {
  if (one) return __syncthreads_count(v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) s += red[i];
  __syncthreads();
  return s;
}

// Rank of entry t among the entries of key[0, n) that are finite, by
// (key, position).  key[t] is finite.
__device__ __forceinline__ int rank_of(const float* key, int n, int t) {
  const float v = key[t];
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const float o = key[j];
    r += (o < v) || (o == v && j < t);
  }
  return r;
}

// xs = the L smallest of the sorted list (ov, oi) and the m sorted new
// entries (nv, ni), the old entries first on ties, by the block: each
// entry's place is its index plus the count of the other side's entries
// before it (binary searches).
__device__ __forceinline__ void merge_lists(const float* ov, const int* oi, float* xv, int* xi,
                                            int L, const float* nv, const int* ni, int m,
                                            int t) {
  for (int i = t; i < L; i += THREADS) {
    const float v = ov[i];
    int lo = 0, hi = m;  // new entries strictly below v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (nv[mid] < v) lo = mid + 1; else hi = mid;
    }
    if (i + lo < L) {
      xv[i + lo] = v;
      xi[i + lo] = oi[i];
    }
  }
  for (int j = t; j < m; j += THREADS) {
    const float v = nv[j];
    int lo = 0, hi = L;  // old entries at or below v
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ov[mid] <= v) lo = mid + 1; else hi = mid;
    }
    if (j + lo < L) {
      xv[j + lo] = v;
      xi[j + lo] = ni[j];
    }
  }
}

// 4-byte words of a block's state: the query row (vector mode), the best
// list and the bucket buffer twice (a merge writes the other copy), 8
// arrays of W slots and 8 of 2W children.
__host__ __device__ __forceinline__ size_t state_words(int dq, int W, int Kh, int Bh) {
  return (size_t)dq + 4 * (size_t)Kh + 4 * (size_t)Bh + 24 * (size_t)W;
}

// kScratch: the block's state in its slice of the global scratch, else in
// dynamic shared memory (an instance of its own, so the shared one
// addresses shared memory directly).
template <bool kScratch>
__global__ void __launch_bounds__(THREADS, 4) beam_kernel(
    const float* __restrict__ queries, const float* __restrict__ X,
    const float* __restrict__ centroids, const float* __restrict__ mu,
    const int* __restrict__ child_in, const int* __restrict__ child_out,
    const float* __restrict__ rad_in, const float* __restrict__ rad_out,
    const int* __restrict__ perm, const unsigned char* __restrict__ valid,
    float* __restrict__ best_d, long long* __restrict__ best_i, long long* __restrict__ buf_out,
    long long* __restrict__ trav_out, long long* __restrict__ cent_out, float* scratch,
    int width, int W, int K, int Kh, int Bcap, int Bh, int depth, float q, int qmode) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[WARPS];

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool rows = X == nullptr;
  const int d = width, dq = rows ? 0 : width, W2 = 2 * W;
  const bool one = W2 <= THREADS;  // a thread owns at most one slot and one child
  const float* qrow = queries + (size_t)b * width;

  float* qs = kScratch ? scratch + (size_t)b * state_words(dq, W, Kh, Bh) : smem;
  float* bv = qs + dq;
  int* bi = reinterpret_cast<int*>(bv + Kh);
  float* bvn = reinterpret_cast<float*>(bi + Kh);
  int* bin = reinterpret_cast<int*>(bvn + Kh);
  float* uv = reinterpret_cast<float*>(bin + Kh);
  int* ui = reinterpret_cast<int*>(uv + Bh);
  float* uvn = reinterpret_cast<float*>(ui + Bh);
  int* uin = reinterpret_cast<int*>(uvn + Bh);
  // the W slots: frontier node and its next, their bounds, the vantage's
  // distance, its key, its mu and its id
  int* front = uin + Bh;
  int* nfront = front + W;
  float* flb = reinterpret_cast<float*>(nfront + W);
  float* nflb = flb + W;
  float* vd = nflb + W;
  float* vkey = vd + W;
  float* smu = vkey + W;
  int* svid = reinterpret_cast<int*>(smu + W);
  // the 2W children (the W in-children, then the W out-children): frontier
  // key, bound, bucket key, subtree radius, pointer, bucket flag; and a
  // level's new entries, sorted
  float* ekey = reinterpret_cast<float*>(svid + W);
  float* ebound = ekey + W2;
  float* bkey = ebound + W2;
  float* erad = bkey + W2;
  int* eptr = reinterpret_cast<int*>(erad + W2);
  int* ebuck = eptr + W2;
  float* nv = reinterpret_cast<float*>(ebuck + W2);
  int* ni = reinterpret_cast<int*>(nv + W2);

  for (int c = t; c < dq; c += THREADS) qs[c] = qrow[c];
  for (int i = t; i < Kh; i += THREADS) {
    bv[i] = INFINITY;
    bi[i] = -1;
  }
  for (int i = t; i < Bh; i += THREADS) {
    uv[i] = INFINITY;
    ui[i] = -1;
  }
  for (int j = t; j < W; j += THREADS) {
    front[j] = j == 0 ? 0 : -1;
    flb[j] = 0.0f;
  }
  // lanes of the distance sum: min(pow2floor(d), 32)
  int w = 32;
  while (w > d) w >>= 1;
  long long ntrav = 0, ncent = 0;
  __syncthreads();

  for (int level = 0; level < depth; ++level) {
    // 0. thread t < 2W takes child t (side t / W of slot t % W) into
    //    registers now, so these reads overlap the distances' row reads
    const bool out = t >= W;
    const int s0 = out ? t - W : t;
    const int node = t < W2 ? front[s0] : -1;
    int vid = -1, child = -1;
    float m_ = 0.0f, rad = 0.0f;
    if (node >= 0) {
      m_ = mu[node];
      child = out ? child_out[node] : child_in[node];
      rad = out ? rad_out[node] : rad_in[node];
      if (!out) vid = perm[node];
    }

    // 1. the frontier's vantage distances
    if (rows) {
      for (int j = t; j < W; j += THREADS) {
        const int nj = front[j];
        const int vj = j == t ? vid : (nj >= 0 ? perm[nj] : -1);
        vd[j] = nj >= 0 ? qrow[vj] : INFINITY;
      }
    } else {
      for (int j = warp; j < W; j += WARPS) {
        const int nj = front[j];
        const float dist = nj >= 0 ? warp_dist(qs, X + (size_t)nj * d, d, w, lane) : INFINITY;
        if (lane == 0) vd[j] = dist;
      }
    }
    // the children into shared memory: t's from its registers, those past
    // the block's threads (W > THREADS / 2) read now
    if (t < W2) {
      eptr[t] = child;
      erad[t] = rad;
      if (!out) {
        smu[t] = m_;
        svid[t] = vid;
      }
    }
    for (int c = t + THREADS; c < W2; c += THREADS) {
      const bool o = c >= W;
      const int s = o ? c - W : c;
      const int nd = front[s];
      eptr[c] = nd >= 0 ? (o ? child_out[nd] : child_in[nd]) : -1;
      erad[c] = nd >= 0 ? (o ? rad_out[nd] : rad_in[nd]) : 0.0f;
      if (!o) {
        smu[s] = nd >= 0 ? mu[nd] : 0.0f;
        svid[s] = nd >= 0 ? perm[nd] : -1;
      }
    }
    int alive = 0;
    for (int j = t; j < W; j += THREADS) alive += front[j] >= 0;
    ntrav += block_count(alive, one, red, lane, warp);

    // 2. the accepted vantages enter the best list, by (distance, slot)
    int enters = 0;
    for (int j = t; j < W; j += THREADS) {
      float key = INFINITY;
      if (front[j] >= 0 && (valid == nullptr || valid[svid[j]])) key = vd[j];
      if (!isfinite(key)) key = INFINITY;
      vkey[j] = key;
      enters += key != INFINITY;
    }
    const int m = block_count(enters, one, red, lane, warp);
    for (int j = t; j < W; j += THREADS) {
      if (vkey[j] != INFINITY) {
        const int r = rank_of(vkey, W, j);
        nv[r] = vkey[j];
        ni[r] = svid[j];
      }
    }
    __syncthreads();
    if (m > 0) {
      merge_lists(bv, bi, bvn, bin, Kh, nv, ni, m, t);
      float* sv = bv; bv = bvn; bvn = sv;
      int* si = bi; bi = bin; bin = si;
      __syncthreads();
    }
    const float tau = Kh == K ? bv[K - 1] : INFINITY;

    // 3. the children: the prune rules, the bounds, the priorities
    for (int j = t; j < W; j += THREADS) {
      nfront[j] = -1;
      nflb[j] = 0.0f;
    }
    int nbuck = 0;
    for (int c = t; c < W2; c += THREADS) {
      const bool o = c >= W;
      const int s = o ? c - W : c;
      float fkey = INFINITY, bound = 0.0f, bk = INFINITY;
      bool isb = false;
      const int ptr = eptr[c];
      if (front[s] >= 0) {
        const float dd = vd[s], mm = smu[s], rr = erad[c];
        bool pruned;
        if (qmode == Q_INF) {
          pruned = o ? fmaxf(dd, tau) < mm : fmaxf(mm, tau) <= dd;
        } else {
          // the normalised powered domain of vptree._prune_rules
          const bool ft = isfinite(tau);
          const float sc = fmaxf(fmaxf(fmaxf(dd, mm), ft ? tau : 0.0f), 1e-30f);
          const float dqq = qpow(__fdiv_rn(dd, sc), q, qmode);
          const float mq = qpow(__fdiv_rn(mm, sc), q, qmode);
          const float tq = ft ? qpow(__fdiv_rn(tau, sc), q, qmode) : INFINITY;
          pruned = o ? __fadd_rn(dqq, tq) < mq : __fadd_rn(mq, tq) <= dqq;
        }
        if (ptr != -1 && !pruned) {
          // out: max(m - d, d - r_out); in: d - r_in (m where r_in is not finite)
          const float lb = o ? fmaxf(fmaxf(__fsub_rn(mm, dd), __fsub_rn(dd, rr)), 0.0f)
                             : fmaxf(__fsub_rn(dd, isfinite(rr) ? rr : mm), 0.0f);
          bound = fmaxf(flb[s], lb);
          const float prio = __fadd_rn(__fmul_rn(bound, 1024.0f), dd);
          if (ptr >= 0) {
            fkey = prio;
          } else {
            isb = true;
            bk = prio;
          }
        }
      }
      ekey[c] = isfinite(fkey) ? fkey : INFINITY;
      ebound[c] = bound;
      ebuck[c] = isb;
      bkey[c] = rows && isfinite(bk) ? bk : INFINITY;
      nbuck += isb;
    }
    const int nb = block_count(nbuck, one, red, lane, warp);

    // 4. vector mode ranks the reached buckets by centroid distance
    if (!rows && nb > 0) {
      ncent += nb;
      for (int e = warp; e < W2; e += WARPS) {
        if (ebuck[e]) {
          const float dc =
              warp_dist(qs, centroids + (size_t)(-(eptr[e] + 2)) * d, d, w, lane);
          if (lane == 0) bkey[e] = isfinite(dc) ? dc : INFINITY;
        }
      }
      __syncthreads();
    }

    // 5. the buckets' new entries; the next frontier
    int benters = 0;
    for (int c = t; c < W2; c += THREADS) {
      const float kb = bkey[c];
      if (kb != INFINITY) {
        const int r = rank_of(bkey, W2, c);
        nv[r] = kb;
        ni[r] = -(eptr[c] + 2);
        ++benters;
      }
      if (ekey[c] != INFINITY) {
        const int r = rank_of(ekey, W2, c);
        if (r < W) {
          nfront[r] = eptr[c];
          nflb[r] = ebound[c];
        }
      }
    }
    const int mb = block_count(benters, one, red, lane, warp);
    if (mb > 0) {
      merge_lists(uv, ui, uvn, uin, Bh, nv, ni, mb, t);
      float* sv = uv; uv = uvn; uvn = sv;
      int* si = ui; ui = uin; uin = si;
    }
    for (int j = t; j < W; j += THREADS) {
      front[j] = nfront[j];
      flb[j] = nflb[j];
    }
    __syncthreads();
  }

  for (int i = t; i < K; i += THREADS) {
    best_d[(size_t)b * K + i] = i < Kh ? bv[i] : INFINITY;
    best_i[(size_t)b * K + i] = i < Kh ? bi[i] : -1;
  }
  for (int i = t; i < Bcap; i += THREADS) buf_out[(size_t)b * Bcap + i] = i < Bh ? ui[i] : -1;
  if (t == 0) {
    trav_out[b] = ntrav;
    cent_out[b] = ncent;
  }
}

}  // namespace

// Every level of the beam for B queries (see the note at the top): queries
// (B, width) f32 — the query rows (vector mode, X (n, width) the
// layout-ordered corpus and centroids (buckets, width)) or the precomputed
// distance rows (rows mode, X and centroids null); the tree's node arrays;
// valid (n,) bytes by original id, or null.  Out: best_d / best_i (B, K),
// buf (B, Bcap), trav / cent (B,).  On `stream`; returns the launch's
// error, cudaErrorInvalidValue for a size below 1 or q below 1.
extern "C" int beam_levels(const float* queries, const float* X, const float* centroids,
                           const float* mu, const int* child_in, const int* child_out,
                           const float* rad_in, const float* rad_out, const int* perm,
                           const unsigned char* valid, float* best_d, long long* best_i,
                           long long* buf, long long* trav, long long* cent, int B, int width,
                           int W, int K, int Bcap, int depth, float q, void* stream) {
  if (B < 0 || W < 1 || K < 1 || Bcap < 1 || width < 1 ||
      (X != nullptr && centroids == nullptr) || depth < 0 || !(q >= 1.0f)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  const int qmode = isinf(q) ? Q_INF
                    : q == 1.0f ? Q_ONE
                    : q == 2.0f ? Q_TWO
                    : q == 3.0f ? Q_THREE
                                : Q_POW;
  // what can ever be finite: W vantages and 2W buckets a level
  const long long reach = (long long)W * depth;
  const int Kh = (int)(K < reach ? K : reach);
  const int Bh = (int)(Bcap < 2 * reach ? Bcap : 2 * reach);
  const size_t bytes = state_words(X != nullptr ? width : 0, W, Kh, Bh) * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bytes + WARPS * sizeof(int) > (size_t)optin) {
    float* scratch = nullptr;
    e = cudaMallocAsync(reinterpret_cast<void**>(&scratch), bytes * (size_t)B, st);
    if (e != cudaSuccess) return e;
    beam_kernel<true><<<B, THREADS, 0, st>>>(
        queries, X, centroids, mu, child_in, child_out, rad_in, rad_out, perm, valid, best_d,
        best_i, buf, trav, cent, scratch, width, W, K, Kh, Bcap, Bh, depth, q, qmode);
    e = cudaGetLastError();
    const cudaError_t f = cudaFreeAsync(scratch, st);
    return e != cudaSuccess ? e : f;
  }
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(beam_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
  }
  beam_kernel<false><<<B, THREADS, bytes, st>>>(
      queries, X, centroids, mu, child_in, child_out, rad_in, rad_out, perm, valid, best_d,
      best_i, buf, trav, cent, nullptr, width, W, K, Kh, Bcap, Bh, depth, q, qmode);
  return cudaGetLastError();
}
