"""Public pairwise-distance entry: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (never a fallback for a CUDA tensor)."""
from __future__ import annotations

import torch

from repro_torch.kernels.pdist.pdist import CUBE_METRICS, MATMUL_METRICS, pdist_cuda
from repro_torch.kernels.pdist.ref import pdist_ref

SUPPORTED = MATMUL_METRICS + CUBE_METRICS


def pdist(X: torch.Tensor, Y: torch.Tensor, *, metric: str = "sqeuclidean") -> torch.Tensor:
    if X.is_cuda:
        return pdist_cuda(X, Y, metric=metric)
    return pdist_ref(X, Y, metric=metric)
