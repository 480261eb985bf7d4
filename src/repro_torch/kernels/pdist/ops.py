"""Public pairwise-distance entry: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors (never a fallback for a CUDA tensor).  Each
call reports its work to an open ``dist/roofline`` capture."""
from __future__ import annotations

import torch

from repro_torch.dist import roofline
from repro_torch.kernels.pdist.pdist import CUBE_METRICS, MATMUL_METRICS, pdist_cuda
from repro_torch.kernels.pdist.ref import pdist_ref

SUPPORTED = MATMUL_METRICS + CUBE_METRICS


@roofline.reports(lambda a: roofline.pdist_work(
    a.X.shape[0], a.Y.shape[0], a.X.shape[1], cube=a.metric in CUBE_METRICS))
def pdist(X: torch.Tensor, Y: torch.Tensor, *, metric: str = "sqeuclidean") -> torch.Tensor:
    if X.is_cuda:
        return pdist_cuda(X, Y, metric=metric)
    return pdist_ref(X, Y, metric=metric)
