"""Public fused top-k entry: the CUDA kernel for CUDA tensors, the plain
blocked merge for CPU tensors (never a fallback for a CUDA tensor)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.pdist.pdist import CUBE_METRICS, MATMUL_METRICS
from repro_torch.kernels.topk.ref import DEFAULT_BLOCK, topk_ref
from repro_torch.kernels.topk.topk import MAX_K, topk_cuda

SUPPORTED = MATMUL_METRICS + CUBE_METRICS

__all__ = ["topk", "SUPPORTED", "MATMUL_METRICS", "CUBE_METRICS", "MAX_K"]


def topk(
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    metric: str = "sqeuclidean",
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``block`` sizes the plain version's panels; the kernel streams
    tiles of its own."""
    if X.is_cuda:
        return topk_cuda(X, Y, k=k, metric=metric, exclude_self=exclude_self,
                         valid=valid)
    return topk_ref(X, Y, k=k, metric=metric, exclude_self=exclude_self,
                    valid=valid, block=block)
