// Shared by the distance kernels (pdist.cu, topk.cu): metric codes and the
// fused epilogue that turns the f32 cross term and the two squared norms
// into a distance — the arithmetic of kernels/pdist/ref.py and of the
// TPU kernels' epilogues (src/repro/kernels/pdist/pdist.py:_matmul_kernel).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rt {

// Must match repro_torch/kernels/pdist/pdist.py:METRIC_CODES.
enum Metric : int { SQEUCLIDEAN = 0, EUCLIDEAN = 1, COSINE = 2, DOT = 3 };

constexpr float EPS = 1e-12f;

__device__ __forceinline__ float epilogue(int metric, float dot, float sx,
                                          float sy) {
  if (metric == DOT) return -dot;
  if (metric == COSINE) {
    const float nx = sqrtf(fmaxf(sx, EPS));
    const float ny = sqrtf(fmaxf(sy, EPS));
    return 1.0f - dot / (nx * ny);
  }
  const float d2 = fmaxf(sx + sy - 2.0f * dot, 0.0f);
  return metric == EUCLIDEAN ? sqrtf(d2) : d2;
}

}  // namespace rt
