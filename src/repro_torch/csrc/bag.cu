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
// in f32, 1 for D = 1); a row that several lookups
// share need only be read once.  Beside the rows, the ids (and weights)
// are read once and the output written once; the arithmetic (2 * B * S *
// D flops) is negligible.  A DeepFM serve_bulk batch (262144 x 39) touches
// ~128 MB of distinct sectors at D = 10 and ~41 MB at D = 1 (the small
// fields repeat): bounds of 0.054 and 0.025 ms at 3.35 TB/s, against which
// this kernel takes 0.20 and 0.12 ms on an H100 (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py); the D = 10 table as bf16 (bound 0.042 ms) takes
// 0.18 ms.  A serve_p99 batch (512 x 39) is bound by its launch.
//
// Design (a first version, right and simple): one thread per output
// element (b, d), with (b, d) flattened over the grid so that warps stay
// full at D = 1 and D = 10.  The thread walks s in order and reads
// ids[b, s] and weights[b, s] itself — the same address for the D threads
// of one row, served by one transaction — and its table element; the D
// threads of a row read neighbouring addresses, so a row's gather is its
// sectors and no more.  Nothing is staged in shared memory: each row is
// used once per bag.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// Must match the order of repro_torch/kernels/bag/ref.py:TABLE_DTYPES.
enum TableDtype : int { F32 = 0, BF16 = 1, F16 = 2 };

// The element type of each code; the kernel is instanced per code, so the
// build report names bag_kernel<0>, <1>, <2>.
template <int DT> struct Element { using type = float; };
template <> struct Element<BF16> { using type = __nv_bfloat16; };
template <> struct Element<F16> { using type = __half; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <int DT>
__global__ void __launch_bounds__(THREADS)
    bag_kernel(const typename Element<DT>::type* __restrict__ table,
               const int* __restrict__ ids,
               const float* __restrict__ weights, float* __restrict__ out,
               long long B, int S, int D, int mean) {
  const long long total = B * D;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    const long long b = e / D;
    const int d = static_cast<int>(e - b * D);
    const int* row_ids = ids + b * S;
    const float* row_w = weights == nullptr ? nullptr : weights + b * S;
    float acc = 0.0f;
    float wsum = 0.0f;
    for (int s = 0; s < S; ++s) {
      const int id = __ldg(row_ids + s);
      const float valid = id >= 0 ? 1.0f : 0.0f;
      const float w =
          row_w == nullptr ? valid : __fmul_rn(__ldg(row_w + s), valid);
      const float x = to_f32(__ldg(table + (size_t)max(id, 0) * D + d));
      acc = __fadd_rn(acc, __fmul_rn(w, x));
      wsum = __fadd_rn(wsum, w);
    }
    if (mean) acc = __fdiv_rn(acc, fmaxf(wsum, 1e-9f));
    out[e] = acc;
  }
}

template <int DT>
void launch(const void* table, const int* ids, const float* weights,
            float* out, long long B, int S, int D, int mean, dim3 grid,
            cudaStream_t stream) {
  using T = typename Element<DT>::type;
  bag_kernel<DT><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(table),
                                               ids, weights, out, B, S, D,
                                               mean);
}

}  // namespace

// table_dtype: a TableDtype code; the output is f32 whatever the table.
extern "C" int bag_f32(const void* table, int table_dtype, const int* ids,
                       const float* weights, float* out, long long B, int S,
                       int D, int mean, void* stream) {
  if (B < 0 || S < 0 || D < 1 || table_dtype < F32 || table_dtype > F16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = B * D;
  if (total == 0) return static_cast<int>(cudaSuccess);
  // enough blocks to fill the card several times over; the grid-stride loop
  // covers the rest
  const long long blocks = (total + THREADS - 1) / THREADS;
  const dim3 grid(static_cast<unsigned>(blocks < 65535 * 8 ? blocks : 65535 * 8));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == F32) {
    launch<F32>(table, ids, weights, out, B, S, D, mean, grid, s);
  } else if (table_dtype == BF16) {
    launch<BF16>(table, ids, weights, out, B, S, D, mean, grid, s);
  } else {
    launch<F16>(table, ids, weights, out, B, S, D, mean, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}
