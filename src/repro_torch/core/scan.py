"""Batched scan engine: k-nearest selection without the (m, n) matrix —
port of ``repro.core.scan``.

Contract (shared with the JAX package): dists (m, k) f32 ascending, idxs
(m, k) int32, ties to the lowest index, (+inf, -1) past the valid
candidates.  ``topk_scan`` goes through ``kernels/topk`` for the metrics
that have a kernel (the CUDA kernel on the card, its blocked plain version
on the CPU) and through the same blocked merge over the metric's matrix
form for jaccard and correlation.

``topk_scan_quant`` is the int8 twin over a ``core/quant.QuantStore``
view: the euclidean family runs the int8 kernel's function (JAX's
``impl="pallas"``: the query is quantised too), any other metric the
blocked merge over one dequantised block at a time.  ``topk_candidates``
re-scores gathered candidate lists exactly: on the card, for the metrics
with a topk kernel, one launch of ``kernels/rescore``; otherwise the plain
gather, pair form and stable sort.  ``quant_candidates`` scores gathered
candidate lists on dequantised codes.

Each scan call counts ``scan_dispatch_total{regime, metric}`` in
``core/telemetry`` (a no-op while telemetry is disabled): ``cuda`` /
``torch`` for the f32 scan, ``cuda_quant`` / ``torch_quant`` for the int8
one, by the device of the kernel's inputs (a metric without a kernel
counts ``torch``).  The JAX package counts traces of its jitted scans;
the port counts calls.  An f32 kernel call at k > 512, which selects from
the scan's written-out distances (``kernels/topk/topk.py:wide_select``),
also counts ``topk_wide_select_total{family=matmul|cube}``.

``torch.topk`` does not reproduce ``lax.top_k``'s lowest-index tie order,
so every selection here is a STABLE sort of [running best, new], which
keeps the earlier entry on ties.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core import telemetry as telem
from repro_torch.kernels.rescore import rescore as rescore_kernel
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk.ref import DEFAULT_BLOCK, blocked_topk

INF = float("inf")

__all__ = ["DEFAULT_BLOCK", "pow2ceil", "topk_scan", "topk_scan_quant",
           "merge_topk", "topk_candidates", "quant_candidates", "in_chunks"]


def pow2ceil(x: int) -> int:
    """Smallest power of two >= x (the repo-wide width-bucketing rule)."""
    p = 1
    while p < x:
        p *= 2
    return p


def topk_scan(
    Q: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    metric: str = "euclidean",
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of Y for every row of Q, streaming over Y.

    Q (m, d), Y (n, d) -> (dists (m, k), idxs (m, k)).  ``exclude_self``
    masks global_row == global_col (Q must be Y row-aligned); ``valid``
    (n,) bool masks candidates out."""
    if metric in topk_ops.SUPPORTED:
        telem.count("scan_dispatch_total", regime="cuda" if Q.is_cuda else "torch",
                    metric=metric)
        if Q.is_cuda and topk_ops.wide_select(k):
            telem.count("topk_wide_select_total",
                        family="cube" if metric in topk_ops.CUBE_METRICS else "matmul")
        return topk_ops.topk(Q, Y, k=k, metric=metric, exclude_self=exclude_self,
                             valid=valid, block=block)
    telem.count("scan_dispatch_total", regime="torch", metric=metric)
    return blocked_topk(
        Q.float(), Y.float(), k=k, dist_fn=metrics_lib.matrix_fn(metric),
        exclude_self=exclude_self, valid=valid, block=block,
    )


def topk_scan_quant(
    Q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    k: int,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
    sqnorms: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_scan`` over int8 corpus codes — the quantized first pass.

    Q (m, d) f32, codes (n, d) int8, scales (d,) f32 -> the usual (dists,
    idxs) contract, with code-space distances.  Sqeuclidean and euclidean
    go to ``kernels/topk.topk_quant`` (``sqnorms`` is the store's
    precomputed norm row); other metrics dequantise ONE block at a time
    against the metric's matrix form, so the (n, d) f32 corpus never
    exists."""
    if metric in topk_ops.QUANT_METRICS:
        telem.count("scan_dispatch_total",
                    regime="cuda_quant" if Q.is_cuda else "torch_quant", metric=metric)
        return topk_ops.topk_quant(Q, codes, scales, k=k, metric=metric,
                                   valid=valid, sqnorms=sqnorms, block=block)
    telem.count("scan_dispatch_total", regime="torch_quant", metric=metric)
    fn = metrics_lib.matrix_fn(metric)
    Qf = Q.float()
    return blocked_topk(
        Qf, codes, k=k, dist_fn=lambda q, c: fn(q, quant_lib.decode(c, scales)),
        valid=valid, block=block,
    )


def merge_topk(
    dists: torch.Tensor, idxs: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge (B, S, kk) per-source top-k lists (sources in ascending-offset
    order, each obeying the scan contract) into one (B, k) top-k.  A stable
    sort over the sources' concatenation keeps earlier sources first on
    ties — the lowest global index, as the JAX running merge does."""
    B = dists.shape[0]
    cat_d = torch.cat(
        [torch.full((B, k), INF, dtype=torch.float32, device=dists.device),
         dists.reshape(B, -1).float()], dim=1)
    cat_i = torch.cat(
        [torch.full((B, k), -1, dtype=torch.int64, device=dists.device),
         idxs.reshape(B, -1).long()], dim=1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
    best_d = cat_d.gather(1, order)
    best_i = torch.where(torch.isinf(best_d), -1, cat_i.gather(1, order))
    return best_d, best_i.to(torch.int32)


def topk_candidates(
    Q: torch.Tensor,
    cand: torch.Tensor,
    X: torch.Tensor,
    *,
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over gathered candidate lists, batched.

    Q (B, d), cand (B, C) dataset ids with -1 padding, X (n, d) -> (idx
    (B, k) int32 dataset ids or -1, dists (B, k) ascending).  The batched
    form of the JAX package's per-query ``topk_candidates`` under ``vmap``:
    rows are gathered, scored with the metric's pair form, and selected
    with a stable sort, so ties go to the earlier candidate position.  An
    id outside [0, n), -1 or past the corpus, is no candidate: it scores
    +inf and reads no row, on either path.

    On the card, for the metrics of ``kernels/topk.SUPPORTED``, one launch
    of ``kernels/rescore`` does it all, each alive row read once and no
    (B, C, d) block written; it raises where it cannot.  Other metrics and
    CPU tensors take the plain version (``_plain_candidates``)."""
    if Q.is_cuda and metric in rescore_kernel.SUPPORTED:
        return rescore_kernel.rescore_cuda(Q.float().contiguous(), cand.contiguous(),
                                           X.float().contiguous(), k=k, metric=metric)
    return _plain_candidates(Q, cand, X, k=k, metric=metric)


def _plain_candidates(Q: torch.Tensor, cand: torch.Tensor, X: torch.Tensor, *,
                      k: int, metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_candidates``' plain version, on any device: the (B, C, d)
    gather a chunk of queries at a time (``in_chunks``), the pair form and
    the stable sort; the reference the kernel is held to."""
    n = X.shape[0]

    def select(q, c):
        c = c.long()
        c = torch.where((c >= 0) & (c < n), c, -1)
        return _select_candidates(q, c, X[c.clamp_min(0)].float(), k=k, metric=metric)

    return in_chunks(select, 4 * cand.shape[1] * X.shape[1], Q, cand)


def quant_candidates(
    Q: torch.Tensor,
    cand: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    k: int,
    metric: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_candidates`` on int8 codes: approximate top-k over gathered
    candidate lists scored against the dequantised codes (the batched form
    of the JAX package's per-query ``quant_candidates`` under ``vmap``).
    No kernel runs here, in either package."""
    def select(q, c):
        return _select_candidates(q, c, quant_lib.decode(codes[c.long().clamp_min(0)], scales),
                                  k=k, metric=metric)

    return in_chunks(select, 4 * cand.shape[1] * codes.shape[1], Q, cand)


#: the most bytes the largest per-chunk intermediate of ``in_chunks`` may take
GATHER_BYTES = 1 << 30


def in_chunks(fn, row_bytes: int, *tensors: torch.Tensor) -> tuple:
    """``fn(*tensors)`` over chunks of their leading (query) dimension, each
    chunk as many rows as keep ``row_bytes`` per row within
    ``GATHER_BYTES`` (at least one), the outputs concatenated.  ``fn`` must
    treat every row on its own, so the result does not depend on the
    chunking."""
    rows = tensors[0].shape[0]
    step = max(1, GATHER_BYTES // max(1, int(row_bytes)))
    if rows <= step:
        return fn(*tensors)
    parts = [fn(*(t[i:i + step] for t in tensors)) for i in range(0, rows, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _select_candidates(Q: torch.Tensor, cand: torch.Tensor, G: torch.Tensor, *,
                       k: int, metric: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Score the gathered rows G (B, C, d) of candidate lists cand (B, C)
    and keep the k best of each list (stable: ties to the earlier
    position); -1 candidates score +inf.  Scores take the metric's pair
    form, whose reductions run along each row whatever the batch, so a
    query's answer does not depend on the queries it shares a call (or a
    chunk) with; a batched matmul's can, on the card."""
    k = int(k)
    cand = cand.long()
    B, C = cand.shape
    D = metrics_lib.pair_fn(metric)(Q.float()[:, None, :], G)
    D = torch.where(cand >= 0, D, INF)
    if C < k:
        D = torch.cat([D, torch.full((B, k - C), INF, device=D.device)], dim=1)
    order = torch.sort(D, dim=1, stable=True).indices[:, :k]
    dists = D.gather(1, order)
    ids = cand.gather(1, order.clamp_max(C - 1))
    idx = torch.where(torch.isinf(dists), -1, ids)
    return idx.to(torch.int32), dists
