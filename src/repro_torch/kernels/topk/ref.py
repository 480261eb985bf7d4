"""Plain PyTorch versions of the fused distance + top-k kernels.

A blocked running merge (``repro.core.scan.topk_scan``'s jnp path): each
step scores one (m, block) panel, concatenates it after the running (m, k)
best and keeps the k smallest with a STABLE sort, so ties go to the lowest
column exactly as ``lax.top_k`` on the negated panel does (``torch.topk``
does not promise that order).  The (m, n) matrix never exists.  Contract:
(dists (m, k) f32 ascending, idxs (m, k) int32), (+inf, -1) past the valid
candidates.

``topk_ref`` is the f32 kernel's function (``csrc/topk.cu``);
``topk_quant_ref`` the int8 kernel's (``csrc/topk_int8.cu``), the
function of JAX's ``topk_quant_pallas``: the query is scale-folded and
row-quantised (``quantize_queries``) and the int8 cross term is computed
exactly, in float64.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import quant as quant_lib
from repro_torch.kernels.pdist.ref import pdist_ref

DEFAULT_BLOCK = 4096
#: metrics the int8 regime serves (the euclidean family: cross-term math)
QUANT_METRICS = ("sqeuclidean", "euclidean")


def blocked_select(
    m: int,
    n: int,
    panel: Callable[[int, int], torch.Tensor],
    *,
    k: int,
    device: torch.device,
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of every row of an (m, n) distance matrix that is
    produced one (m, stop - start) column panel at a time by
    ``panel(start, stop)``."""
    k = int(k)
    bn = max(1, min(int(block), n))
    best_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=device)
    best_i = torch.full((m, k), -1, dtype=torch.int64, device=device)
    rows = torch.arange(m, device=device)[:, None]
    for start in range(0, n, bn):
        cols = torch.arange(start, min(start + bn, n), device=device)
        D = panel(start, start + bn).float()
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


def merge_splits_ref(part_d: torch.Tensor, part_i: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest by (distance, column) of each row's S sorted lists,
    (m, S, k) -> (m, k): the function of the kernels' merge of their
    column splits (``csrc/topk.cu:merge_kernel``).  Two stable sorts, by
    column then by distance; the (+inf, -1) slots sort last."""
    m = part_d.shape[0]
    d, i = part_d.reshape(m, -1), part_i.reshape(m, -1)
    order = torch.sort(i, dim=1, stable=True).indices
    d, i = d.gather(1, order), i.gather(1, order)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return d.gather(1, order), i.gather(1, order)


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
    return blocked_select(
        Q.shape[0], Y.shape[0], lambda s, e: dist_fn(Q, Y[s:e]), k=k,
        device=Q.device, exclude_self=exclude_self, valid=valid, block=block,
    )


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


def quantize_queries(
    Q: torch.Tensor, scales: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 regime's query side, as ``repro/kernels/topk/topk.py:404-408``
    forms it: fold the corpus scales into the query (``xs = Q * s``) and
    row-quantise it under its own absmax.  Returns (xq (m, d) int8, alpha
    (m,) f32, xn (m,) f32 = |Q|^2)."""
    Q = Q.float()
    xs = Q * scales[None, :]
    alpha = quant_lib.absmax_scales(xs, axis=1, keepdims=True)
    xq = quant_lib.encode(xs, alpha)
    return xq, alpha[:, 0], (Q * Q).sum(1)


def quant_dists(xq: torch.Tensor, alpha: torch.Tensor, xn: torch.Tensor,
                codes: torch.Tensor, sqnorms: torch.Tensor, metric: str) -> torch.Tensor:
    """The int8 kernel's (m, n) distance panel: the cross term xq . c in
    float64 (exact for every d, where f32 is not once 127^2 * d >= 2^24),
    rounded to f32 once, then ``max(|q|^2 + |dec(c)|^2 - 2 alpha acc, 0)``
    in f32, and its sqrt for euclidean."""
    acc = (xq.double() @ codes.double().T).float()
    cross = acc * alpha[:, None]
    d2 = (xn[:, None] + sqnorms[None, :] - 2.0 * cross).clamp_min(0.0)
    return torch.sqrt(d2) if metric == "euclidean" else d2


def topk_quant_ref(
    Q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    sqnorms: torch.Tensor,
    *,
    k: int,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest corpus codes for every f32 query row, by the int8 kernel's
    arithmetic (see ``quantize_queries`` and ``quant_dists``)."""
    if metric not in QUANT_METRICS:
        raise ValueError(f"int8 topk regime does not support metric {metric!r}")
    xq, alpha, xn = quantize_queries(Q, scales)
    return blocked_select(
        Q.shape[0], codes.shape[0],
        lambda s, e: quant_dists(xq, alpha, xn, codes[s:e], sqnorms[s:e], metric),
        k=k, device=Q.device, valid=valid, block=block,
    )
