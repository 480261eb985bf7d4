"""Public embedding-bag entry: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors (never a fallback for a CUDA tensor).  Each call
reports its work to an open ``dist/roofline`` capture."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import roofline
from repro_torch.kernels.bag.bag import embedding_bag_cuda
from repro_torch.kernels.bag.ref import embedding_bag_ref


@roofline.reports(lambda a: roofline.bag_work(
    a.ids, a.table.shape[1], weighted=a.weights is not None, elem=a.table.element_size()))
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
