// A design of the embedding bag that src/repro_torch/csrc/bag.cu does not
// ship, built by tools/profile_bag.py (with -I src/repro_torch/csrc) and
// timed beside it, held bit for bit to the plain version
// (kernels/bag/ref.py): bag_float2, bag.cu's staged, chunked thread path
// with two neighbouring outputs a thread, read as one 8-byte load (f32
// tables, D even: a row of D floats starts 8-byte aligned).  It folds each
// output in ascending s with every product and sum rounded on its own, as
// bag.cu does.
#include "bag.cu"

namespace {

// bag_kernel (bag.cu) with output pairs: e counts (b, q), q < D / 2.
template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
    pair_kernel(const float2* __restrict__ table, const int* __restrict__ ids,
                const float* __restrict__ weights, float* __restrict__ out,
                long long B, int S, int D, int mean, int bags, int window) {
  extern __shared__ __align__(16) float smem[];
  float* const smem_w = smem + staged_words(static_cast<long long>(bags) * window);
  const int H = D / 2;
  const long long b0 = static_cast<long long>(blockIdx.x) * bags;
  const int rows = static_cast<int>(min(static_cast<long long>(bags), B - b0));
  const int elems = rows * H;
  const int* sid = nullptr;
  const float* sw = nullptr;
  for (int e0 = 0; e0 < elems; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    const bool active = e < elems;
    const int r = active ? e / H : 0;
    const int q = active ? e - r * H : 0;
    float acc0 = 0.0f, acc1 = 0.0f;
    float wsum = 0.0f;
    for (int lo = 0; lo < S; lo += window) {
      const int n = min(window, S - lo);
      if (e0 == 0 || window < S) {
        if (e0 > 0 || lo > 0) __syncthreads();
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
      for (int c = 0; c < n; c += G) {
        float2 x[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (c + j < n) x[j] = __ldg(table + static_cast<size_t>(max(rid[c + j], 0)) * H + q);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (c + j < n) {
            const float valid = rid[c + j] >= 0 ? 1.0f : 0.0f;
            const float w = rw == nullptr ? valid : __fmul_rn(rw[c + j], valid);
            acc0 = __fadd_rn(acc0, __fmul_rn(w, x[j].x));
            acc1 = __fadd_rn(acc1, __fmul_rn(w, x[j].y));
            wsum = __fadd_rn(wsum, w);
          }
        }
      }
    }
    if (active) {
      if (mean) {
        acc0 = __fdiv_rn(acc0, fmaxf(wsum, 1e-9f));
        acc1 = __fdiv_rn(acc1, fmaxf(wsum, 1e-9f));
      }
      reinterpret_cast<float2*>(out)[b0 * H + e] = make_float2(acc0, acc1);
    }
  }
}

template <int G>
int launch_pairs(const float* table, const int* ids, const float* weights, float* out,
                 long long B, int S, int D, int mean, int threads, int bags, int window,
                 unsigned blocks, int smem, cudaStream_t stream) {
  pair_kernel<G><<<blocks, threads, smem, stream>>>(
      reinterpret_cast<const float2*>(table), ids, weights, out, B, S, D, mean, bags,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 tables, D even; the plan is bag_f32's for D / 2 outputs a bag.
extern "C" int bag_float2(const float* table, const int* ids, const float* weights,
                          float* out, long long B, int S, int D, int mean, int threads,
                          int bags, int chunk, int window, void* stream) {
  if (B < 1 || S < 1 || D < 2 || D % 2 != 0 || threads < 32 || threads > MAX_THREADS ||
      bags < 1 || window < 1 || (window < S && bags != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4 * staged_words(static_cast<long long>(bags) * window) *
                         (weights == nullptr ? 1 : 2);
  if (smem > SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((B + bags - 1) / bags);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  switch (chunk) {
    case 4:
      return launch_pairs<4>(table, ids, weights, out, B, S, D, mean, threads, bags, window,
                             blocks, bytes, s);
    case 8:
      return launch_pairs<8>(table, ids, weights, out, B, S, D, mean, threads, bags, window,
                             blocks, bytes, s);
    case 16:
      return launch_pairs<16>(table, ids, weights, out, B, S, D, mean, threads, bags,
                              window, blocks, bytes, s);
    case 40:
      return launch_pairs<40>(table, ids, weights, out, B, S, D, mean, threads, bags,
                              window, blocks, bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
