// Embedding bag: gather + weighted sum (or mean) of table rows.
//
// Replaces the TPU kernel src/repro/kernels/bag/bag.py:_bag_kernel (entry
// embedding_bag_pallas).  table (V, D) f32, bf16 or f16, ids (B, S) int32,
// optional weights (B, S) f32 -> out (B, D) f32:
//     w[b, s]   = (weights ? weights[b, s] : 1) * (ids[b, s] >= 0)
//     out[b, :] = sum_s w[b, s] * f32(table[max(ids[b, s], 0), :])
// and for `mean` out[b, :] /= max(sum_s w[b, s], 1e-9).  A padding id
// (< 0) reads row 0 with weight 0: the product 0 * row is still formed, so
// a non-finite row 0 gives NaN there, as in both JAX versions.  The sum
// runs in ascending s, as the TPU kernel's grid does, and every product
// and sum is rounded on its own (__fmul_rn, __fadd_rn: no FMA), so the
// plain version (kernels/bag/ref.py, the same loop over s in torch) gives
// the same bits.  A bf16 or f16 table is read in its own type and each
// element converted to f32 (__bfloat162float, __half2float: exact) before
// the product, as the TPU kernel's table_ref[...].astype(jnp.float32)
// does; the table is never copied to f32.  Ids >= V are the caller's
// fault, as in JAX.
//
// Bound: bytes.  Each lookup gathers a D-element row (4 bytes an element in
// f32, 2 in bf16 / f16), which costs whole 32-byte sectors (2 for D = 10
// in f32, 1 for D = 1); a row that several lookups share need only be read
// once.  Beside the rows, the ids (and weights) are read once and the
// output written once; the arithmetic (2 * B * S * D flops) is negligible.
// A DeepFM serve_bulk batch (262144 x 39) touches ~128 MB of distinct
// sectors at D = 10 and ~41 MB at D = 1 (the small fields repeat): bounds
// of 0.054 and 0.025 ms at 3.35 TB/s.  Without reuse the same lookups cost
// 327 MB of sectors at D = 1, served from L2 where rows repeat.  A small
// batch (serve_p99's 512 bags, a retrieval's 1 to 32) moves a few KB: its
// time is the launch and the round trips of its dependent loads (an id,
// then the row it names), not bytes.  Times against these bounds, for
// both paths and the designs tried beside them: PERF.md section 6
// (chip_smoke.py, tools/profile_bag.py).
//
// Design: two paths, chosen by kernels/bag/bag.py:launch_plan from the
// batch (the plan is passed in by the caller).
//
// bag_kernel, one thread an output, for batches that fill the card.  A
// block owns a tile of `bags` consecutive bags; their ids (and weights)
// are one contiguous span of memory, staged into shared memory by cp.async
// in 16-byte chunks (single words at the span's ragged ends, and the
// shared copy offset so that both sides of each chunk are aligned,
// whatever the base: a row-slice view of ids starts anywhere).  Each
// thread then owns one output element (b, d) and walks s in chunks of G:
// it issues the G table loads of a chunk (independent, all in flight) into
// registers, then folds them in ascending s.  So a bag's S serial round
// trips become ceil(S / G) (one for S <= 40), and the warps' id reads are
// coalesced copies instead of 32 lines a load.  Blocks hold 256 threads
// where the outputs fill the card, fewer where they do not.  Where one
// bag's ids exceed the shared-memory budget, a block owns one bag and
// stages its ids `window` at a time.
//
// bag_warp_kernel, one warp a bag, for few outputs of small bags (the
// serve_p99 batch's 512 x 39 at D = 1): the bags spread over the SMs (171
// blocks of 3 warps, where bag_kernel would fill 16 blocks of 32 threads),
// each bag's gathers run across the lanes at once, and the code stays
// short: on a one-id bag bag_kernel's unrolled chunk of 40 reads ~1.8 us
// over its chunk of 4 (instruction fetch, inferred, not measured apart),
// which a small batch does not hide.
//
// bag_backward: the gradient of the bag with respect to its f32 table.
// No TPU kernel to replace: the JAX package trains through jnp.take
// (src/repro/dist/embedlookup.py), whose VJP is XLA's scatter-add.
// g (B, D) f32, ids (B, S) int32, optional weights (B, S) f32, grad (V, D)
// f32 zeroed by the caller:
//     grad[ids[b, s], d] += w[b, s] * (g[b, d] / div[b])
// for every id >= 0, with div[b] = max(sum_s w[b, s], 1e-9) under `mean`
// (the forward's denominator, summed in ascending s as the forward sums
// it) and 1 under `sum`.  One thread owns one (bag, column) of g: it reads
// g once, walks the bag's ids and adds each product to its row with an
// f32 atomicAdd.  The products are rounded as the plain version rounds
// them (kernels/bag/ref.py:embedding_bag_backward_ref), but the atomics
// land in whatever order the threads reach them, so a row named by
// several bags sums in another order than index_add_ does: the two agree
// to rounding (rtol 1e-5 / atol 1e-7 in chip_smoke.py and the card tests),
// not bit for bit, and two runs may differ in the last bits.
//
// Bound: bytes.  The ids (and weights) and g are read once; each of the
// B * S * D contributions is a read-modify-write of a 4-byte value in L2
// (an atomic), and the dense (V, D) gradient the caller zeroes is written
// once.  For DeepFM's train batch (65536 x 39, D = 1, V = 30 226 432) the
// zeroed gradient is 121 MB and the ids 10 MB: the memset, not the 2.6 M
// atomics, is most of the bytes.  A faster design (ids sorted by row,
// segmented sums without atomics) is later work (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// Must match repro_torch/kernels/bag/bag.py:MAX_THREADS, CHUNKS and
// SMEM_BYTES: the most threads a block takes, the chunk lengths G the
// kernel is instanced for, the dynamic shared memory a block may ask for
// (no opt-in needed up to 48 KB).
constexpr int MAX_THREADS = 256;
constexpr int SMEM_BYTES = 48 * 1024;

// Must match the order of repro_torch/kernels/bag/ref.py:TABLE_DTYPES.
enum TableDtype : int { F32 = 0, BF16 = 1, F16 = 2 };

// The element type of each code; the kernel is instanced per code and
// chunk, so the build report names bag_kernel<0,8>, <1,8>, ...
template <int DT> struct Element { using type = float; };
template <> struct Element<BF16> { using type = __nv_bfloat16; };
template <> struct Element<F16> { using type = __half; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Shared words one staged span of n words takes: up to 3 words of offset
// (below) and whole 16-byte chunks.  Must match bag.py:staged_words.
__host__ __device__ constexpr long long staged_words(long long n) {
  return (n + 6) & ~3LL;
}

// The n 4-byte words at src into shared memory by cp.async, the block's
// threads each taking a share: 16-byte chunks where a 16-byte block of
// src lies whole inside the span, single words at its ragged ends.  The
// words land at dst + (src's word offset in its 16-byte block), so both
// sides of every chunk are 16-byte aligned (dst is); returns that start.
// The caller commits and waits.
__device__ __forceinline__ const float* stage(float* dst, const float* src, int n) {
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* to = dst + shift;
  const int head = min(n, (4 - shift) & 3);
  const int body = (n - head) & ~3;
  for (int c = threadIdx.x; c < body / 4; c += blockDim.x)
    rt::cp_async16(to + head + 4 * c, src + head + 4 * c, true);
  // the head's words, then the tail's (i = head + body + (t - head))
  for (int t = threadIdx.x; t < n - body; t += blockDim.x) {
    const int i = t < head ? t : body + t;
    rt::cp_async4(to + i, src + i, true);
  }
  return to;
}

template <int DT, int G>
__global__ void __launch_bounds__(MAX_THREADS)
    bag_kernel(const typename Element<DT>::type* __restrict__ table,
               const int* __restrict__ ids, const float* __restrict__ weights,
               float* __restrict__ out, long long B, int S, int D, int mean,
               int bags, int window) {
  extern __shared__ __align__(16) float smem[];
  float* const smem_w = smem + staged_words(static_cast<long long>(bags) * window);
  const long long b0 = static_cast<long long>(blockIdx.x) * bags;
  const int rows = static_cast<int>(min(static_cast<long long>(bags), B - b0));
  const int elems = rows * D;
  const int* sid = nullptr;
  const float* sw = nullptr;
  for (int e0 = 0; e0 < elems; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    const bool active = e < elems;
    const int r = active ? e / D : 0;
    const int d = active ? e - r * D : 0;
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int lo = 0; lo < S; lo += window) {
      const int n = min(window, S - lo);
      // The tile is staged once, unless S is cut into windows (the block
      // then owns one bag).  Either way it is one contiguous span: rows
      // bags of S ids, or n ids of one bag.
      if (e0 == 0 || window < S) {
        if (e0 > 0 || lo > 0) __syncthreads();  // the last window is read
        const long long at = b0 * S + lo;
        sid = reinterpret_cast<const int*>(
            stage(smem, reinterpret_cast<const float*>(ids + at), rows * n));
        if (weights != nullptr) sw = stage(smem_w, weights + at, rows * n);
        rt::cp_commit();
        rt::cp_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      const int* rid = sid + r * n;
      const float* rw = weights == nullptr ? nullptr : sw + r * n;
      const typename Element<DT>::type* col = table + d;
      for (int c = 0; c < n; c += G) {
        // the chunk's G gathers, all in flight, then their fold in order
        typename Element<DT>::type x[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (c + j < n) x[j] = __ldg(col + static_cast<size_t>(max(rid[c + j], 0)) * D);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (c + j < n) {
            const float valid = rid[c + j] >= 0 ? 1.0f : 0.0f;
            const float w = rw == nullptr ? valid : __fmul_rn(rw[c + j], valid);
            acc = __fadd_rn(acc, __fmul_rn(w, to_f32(x[j])));
            wsum = __fadd_rn(wsum, w);
          }
        }
      }
    }
    if (active) {
      if (mean) acc = __fdiv_rn(acc, fmaxf(wsum, 1e-9f));
      out[b0 * D + e] = acc;
    }
  }
}

// One warp a bag.  The lanes stage the bag's ids and weights in shared
// slots, issue the S x D gathers of the bag, (s, d) pairs strided over the
// lanes, into shared slots converted to f32 (exact), and lane d folds
// column d in ascending s.  A block holds blockDim.x / 32 bags; the plan
// keeps S * (D + 2) words a warp inside SMEM_BYTES.
template <int DT>
__global__ void __launch_bounds__(MAX_THREADS)
    bag_warp_kernel(const typename Element<DT>::type* __restrict__ table,
                    const int* __restrict__ ids, const float* __restrict__ weights,
                    float* __restrict__ out, long long B, int S, int D, int mean) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (b >= B) return;  // the whole warp
  int* rid = reinterpret_cast<int*>(smem) + static_cast<size_t>(warp) * S * (D + 2);
  float* rw = reinterpret_cast<float*>(rid + S);
  float* xs = rw + S;
  for (int s = lane; s < S; s += 32) {
    const int id = ids[b * S + s];
    const float valid = id >= 0 ? 1.0f : 0.0f;
    rid[s] = max(id, 0);
    rw[s] = weights == nullptr ? valid : __fmul_rn(weights[b * S + s], valid);
  }
  __syncwarp();
#pragma unroll 8
  for (int p = lane; p < S * D; p += 32) {
    const int s = p / D;
    xs[p] = to_f32(__ldg(table + static_cast<size_t>(rid[s]) * D + (p - s * D)));
  }
  __syncwarp();
  for (int d = lane; d < D; d += 32) {
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int s = 0; s < S; ++s) {
      acc = __fadd_rn(acc, __fmul_rn(rw[s], xs[s * D + d]));
      wsum = __fadd_rn(wsum, rw[s]);
    }
    if (mean) acc = __fdiv_rn(acc, fmaxf(wsum, 1e-9f));
    out[b * D + d] = acc;
  }
}

template <int DT>
int launch_warps(const void* table, const int* ids, const float* weights, float* out,
                 long long B, int S, int D, int mean, int threads, unsigned blocks,
                 int smem, cudaStream_t stream) {
  using T = typename Element<DT>::type;
  bag_warp_kernel<DT><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(table), ids, weights, out, B, S, D, mean);
  return static_cast<int>(cudaGetLastError());
}

template <int DT, int G>
int launch(const void* table, const int* ids, const float* weights, float* out,
           long long B, int S, int D, int mean, int threads, int bags,
           int window, unsigned blocks, int smem, cudaStream_t stream) {
  using T = typename Element<DT>::type;
  bag_kernel<DT, G><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(table), ids, weights, out, B, S, D, mean, bags, window);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_chunk(int chunk, const void* table, const int* ids,
                 const float* weights, float* out, long long B, int S, int D,
                 int mean, int threads, int bags, int window, unsigned blocks,
                 int smem, cudaStream_t stream) {
  switch (chunk) {
    case 4:
      return launch<DT, 4>(table, ids, weights, out, B, S, D, mean, threads, bags,
                           window, blocks, smem, stream);
    case 8:
      return launch<DT, 8>(table, ids, weights, out, B, S, D, mean, threads, bags,
                           window, blocks, smem, stream);
    case 16:
      return launch<DT, 16>(table, ids, weights, out, B, S, D, mean, threads, bags,
                            window, blocks, smem, stream);
    case 40:
      return launch<DT, 40>(table, ids, weights, out, B, S, D, mean, threads, bags,
                            window, blocks, smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    bag_backward_kernel(const float* __restrict__ g, const int* __restrict__ ids,
                        const float* __restrict__ weights, float* __restrict__ grad,
                        long long B, int S, int D, int mean) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= B * D) return;
  const long long b = e / D;
  const int d = static_cast<int>(e - b * D);
  const int* rid = ids + b * S;
  const float* rw = weights == nullptr ? nullptr : weights + b * S;
  float gv = g[e];
  if (mean) {
    float wsum = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float valid = rid[s] >= 0 ? 1.0f : 0.0f;
      wsum = __fadd_rn(wsum, rw == nullptr ? valid : __fmul_rn(rw[s], valid));
    }
    gv = __fdiv_rn(gv, fmaxf(wsum, 1e-9f));
  }
  for (int s = 0; s < S; ++s) {
    const int id = rid[s];
    if (id < 0) continue;
    const float contrib = rw == nullptr ? gv : __fmul_rn(rw[s], gv);
    atomicAdd(grad + static_cast<size_t>(id) * D + d, contrib);
  }
}

}  // namespace

// The bag's backward (see the header): grad (V, D) must be zeroed by the
// caller; threads a block (whole warps, at most MAX_THREADS), one thread
// an element of g.
extern "C" int bag_backward(const float* g, const int* ids, const float* weights,
                            float* grad, long long B, int S, int D, int mean,
                            int threads, void* stream) {
  if (B < 0 || S < 0 || D < 1 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (B * D + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  bag_backward_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(g, ids, weights, grad, B, S,
                                                             D, mean);
  return static_cast<int>(cudaGetLastError());
}

// table_dtype: a TableDtype code; the output is f32 whatever the table.
// threads, bags, chunk, window, warp: the launch plan (bag.py:launch_plan)
// — threads per block (whole warps, at most MAX_THREADS) and the
// consecutive bags a block owns; with warp, bag_warp_kernel (bags =
// threads / 32, window = S, chunk unused), else bag_kernel with `chunk`
// gathers a thread issues before it folds them (one of the instanced
// chunks) and the ids of a bag staged at a time (`window`: S, or less with
// bags == 1).
extern "C" int bag_f32(const void* table, int table_dtype, const int* ids,
                       const float* weights, float* out, long long B, int S,
                       int D, int mean, int threads, int bags, int chunk,
                       int window, int warp, void* stream) {
  if (B < 0 || S < 0 || D < 1 || table_dtype < F32 || table_dtype > F16 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || bags < 1 ||
      window < 1 || (window < S && bags != 1) || (warp && bags != threads / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      warp ? 4LL * S * (D + 2) * bags
           : 4 * staged_words(static_cast<long long>(bags) * window) *
                 (weights == nullptr ? 1 : 2);
  const long long blocks = (B + bags - 1) / bags;
  if (smem > SMEM_BYTES || blocks > 0x7fffffffLL ||
      static_cast<long long>(bags) * D > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  const int bytes = static_cast<int>(smem);
  if (warp) {
    if (table_dtype == F32)
      return launch_warps<F32>(table, ids, weights, out, B, S, D, mean, threads, grid,
                               bytes, s);
    if (table_dtype == BF16)
      return launch_warps<BF16>(table, ids, weights, out, B, S, D, mean, threads, grid,
                                bytes, s);
    return launch_warps<F16>(table, ids, weights, out, B, S, D, mean, threads, grid,
                             bytes, s);
  }
  if (table_dtype == F32)
    return launch_chunk<F32>(chunk, table, ids, weights, out, B, S, D, mean, threads,
                             bags, window, grid, bytes, s);
  if (table_dtype == BF16)
    return launch_chunk<BF16>(chunk, table, ids, weights, out, B, S, D, mean, threads,
                              bags, window, grid, bytes, s);
  return launch_chunk<F16>(chunk, table, ids, weights, out, B, S, D, mean, threads,
                           bags, window, grid, bytes, s);
}
