"""Plain PyTorch version of the fused distance + top-k kernel.

A blocked running merge (``repro.core.scan.topk_scan``'s jnp path): each
step scores one (m, block) panel, concatenates it after the running (m, k)
best and keeps the k smallest with a STABLE sort, so ties go to the lowest
column exactly as ``lax.top_k`` on the negated panel does (``torch.topk``
does not promise that order).  The (m, n) matrix never exists.  Contract:
(dists (m, k) f32 ascending, idxs (m, k) int32), (+inf, -1) past the valid
candidates.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.pdist.ref import pdist_ref

DEFAULT_BLOCK = 4096


def blocked_topk(
    Q: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    dist_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of Y for every row of Q under ``dist_fn`` (a matrix
    form), streaming Y in row blocks of ``block``."""
    m, n, k = Q.shape[0], Y.shape[0], int(k)
    dev = Q.device
    bn = max(1, min(int(block), n))
    best_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(m, device=dev)[:, None]
    for start in range(0, n, bn):
        cols = torch.arange(start, min(start + bn, n), device=dev)
        D = dist_fn(Q, Y[start:start + bn]).float()
        if valid is not None:
            D = torch.where(valid[cols].bool()[None, :], D, float("inf"))
        if exclude_self:
            D = torch.where(cols[None, :] == rows, float("inf"), D)
        cat_d = torch.cat([best_d, D], dim=1)
        cat_i = torch.cat([best_i, cols[None, :].expand(m, -1)], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = cat_d.gather(1, order)
        best_i = cat_i.gather(1, order)
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i.to(torch.int32)


def topk_ref(
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    metric: str = "sqeuclidean",
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    return blocked_topk(
        X.float(), Y.float(), k=k,
        dist_fn=lambda a, b: pdist_ref(a, b, metric=metric),
        exclude_self=exclude_self, valid=valid, block=block,
    )
