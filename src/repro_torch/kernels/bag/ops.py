"""Public embedding-bag entry: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (never a fallback for a CUDA tensor)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.bag.bag import embedding_bag_cuda
from repro_torch.kernels.bag.ref import embedding_bag_ref


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """table (V, D) f32, bf16 or f16, ids (B, S) -> (B, D) f32: the weighted
    sum (or mean) of the rows each bag names; ids below 0 are padding
    (weight 0)."""
    if table.is_cuda:
        return embedding_bag_cuda(table, ids, weights, combine=combine)
    return embedding_bag_ref(table, ids, weights, combine=combine)
