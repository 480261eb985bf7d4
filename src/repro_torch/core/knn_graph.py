"""Exact k-nearest-neighbor graphs — port of ``repro.core.knn_graph`` (the
substrate of the sparse projection)."""
from __future__ import annotations

import torch

from repro_torch.core import scan as scan_lib


def knn_graph(
    X: torch.Tensor, *, k: int, metric: str = "euclidean", block: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of every row of X within X (self excluded).

    Returns (indices (n, k) int32, distances (n, k) f32), ascending.  The
    self-exclusion is an index mask inside the top-k merge (on the card:
    inside the topk CUDA kernel), so no (n, n) matrix is built."""
    dists, idx = scan_lib.topk_scan(
        X, X, k=k, metric=metric, exclude_self=True,
        block=block or scan_lib.DEFAULT_BLOCK,
    )
    return idx, dists


def knn_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean (n, n) adjacency from kNN indices (symmetrised by the caller
    inside ``sparse_canonical_projection``)."""
    mask = torch.zeros((n, n), dtype=torch.bool, device=idx.device)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    mask[rows, idx.long()] = True
    return mask
