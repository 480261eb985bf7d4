"""Canonical q-metric projection P*_q (paper §3, App. E, Algs. 4-7) — port
of ``repro.core.qmetric``.

The projection is path doubling over a (min, combine) semiring: finite q
works in the log-power domain ``L = q log d`` with combine = logaddexp,
q = inf in the distance domain with combine = max.  Every sweep is one
``semiring_matmul``; on a CUDA tensor that is the ``kernels/qpath`` CUDA
kernel, on a CPU tensor its row-blocked plain version.  Masked
(non-neighbour) entries are +inf and propagate through both semirings.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.qpath import ops as qpath_ops

INF = float("inf")

__all__ = [
    "semiring_matmul",
    "canonical_projection",
    "sparse_canonical_projection",
    "project_with_queries",
    "floyd_warshall_reference",
    "is_q_metric",
    "q_violation",
    "to_log_domain",
    "from_log_domain",
]


def to_log_domain(D: torch.Tensor, q: float) -> torch.Tensor:
    """``L = q * log D`` with D=0 -> -inf and D=inf -> +inf."""
    return q * torch.log(D)


def from_log_domain(L: torch.Tensor, q: float) -> torch.Tensor:
    return torch.exp(L / q)


def semiring_matmul(
    A: torch.Tensor, B: torch.Tensor, *, mode: str = "minmax", row_block: int = 32
) -> torch.Tensor:
    """``C[i,j] = min_k combine(A[i,k], B[k,j])``; mode 'logminplus'
    (logaddexp), 'minplus' (+) or 'minmax' (max).  ``row_block`` bounds
    the plain version's (rows, k, n) intermediate."""
    return qpath_ops.qpath_matmul(A, B, mode=mode, row_block=row_block)


def _num_sweeps(n: int) -> int:
    """Path doubling: after t sweeps, optimal over paths of <= 2^t edges."""
    return max(1, math.ceil(math.log2(max(n - 1, 2))))


def canonical_projection(
    D: torch.Tensor,
    q: float,
    *,
    num_sweeps: Optional[int] = None,
    row_block: int = 32,
) -> torch.Tensor:
    """Dense canonical projection ``P*_q(D)`` (Algorithms 4 & 5)."""
    sweeps = _num_sweeps(D.shape[0]) if num_sweeps is None else num_sweeps
    if math.isinf(q):
        M = D
        for _ in range(sweeps):
            M = torch.minimum(M, semiring_matmul(M, M, mode="minmax", row_block=row_block))
        return M
    L = to_log_domain(D, q)
    for _ in range(sweeps):
        L = torch.minimum(L, semiring_matmul(L, L, mode="logminplus", row_block=row_block))
    return from_log_domain(L, q)


def sparse_canonical_projection(
    D: torch.Tensor,
    mask: torch.Tensor,
    q: float,
    *,
    num_hops: int = 8,
    row_block: int = 32,
    schedule: str = "bellman",
) -> torch.Tensor:
    """Sparse projection restricted to a neighbourhood graph (Algs. 6/7).

    ``mask`` is a boolean (n, n) adjacency, symmetrised here.  schedule
    'bellman': M <- min(M, M (*) E), paths of <= t+1 edges after t sweeps;
    'doubling': M <- min(M, M (*) M), paths of <= 2^t edges (the index
    build's schedule).  Unreachable pairs stay +inf."""
    n = D.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    allowed = mask | mask.T | eye
    doubling = schedule == "doubling"
    if math.isinf(q):
        E = torch.where(allowed, D, INF)
        mode = "minmax"
    else:
        E = torch.where(allowed, to_log_domain(D, q), INF)
        mode = "logminplus"
    M = E
    for _ in range(num_hops):
        rhs = M if doubling else E
        M = torch.minimum(M, semiring_matmul(M, rhs, mode=mode, row_block=row_block))
    return M if math.isinf(q) else from_log_domain(M, q)


def project_with_queries(
    D: torch.Tensor, dq_rows: torch.Tensor, q: float, *, row_block: int = 32
) -> torch.Tensor:
    """Projected query-to-dataset distances ``E_q(x_o, x)`` for a batch of
    queries: ``D`` the (n, n) dataset dissimilarity, ``dq_rows`` the (B, n)
    query-to-dataset dissimilarities.  A q-shortest path from x_o to x is
    the direct edge or an edge (x_o, z) then a q-shortest path from z to x
    within X (x_o has degree n and appears once on a simple path):

        E_q(x_o, x) = min(d(x_o, x), min_z combine(d(x_o, z), D_q(z, x)))

    so one projection of D and one semiring product of the query rows by
    D_q, both through ``semiring_matmul`` (the qpath kernel on the card)."""
    Dq = canonical_projection(D, q, row_block=row_block)
    if math.isinf(q):
        via = semiring_matmul(dq_rows, Dq, mode="minmax", row_block=row_block)
        return torch.minimum(dq_rows, via)
    Lrows = to_log_domain(dq_rows, q)
    LD = to_log_domain(Dq, q)
    via = semiring_matmul(Lrows, LD, mode="logminplus", row_block=row_block)
    return from_log_domain(torch.minimum(Lrows, via), q)


def floyd_warshall_reference(D: torch.Tensor, q: float) -> torch.Tensor:
    """Literal Algorithm 4/5: sequential pivots (the test oracle)."""
    n = D.shape[0]
    if math.isinf(q):
        M = D
        for i in range(n):
            M = torch.minimum(M, torch.maximum(M[:, i][:, None], M[i, :][None, :]))
        return M
    L = to_log_domain(D, q)
    for i in range(n):
        L = torch.minimum(L, torch.logaddexp(L[:, i][:, None], L[i, :][None, :]))
    return from_log_domain(L, q)


def q_violation(D: torch.Tensor, q: float) -> torch.Tensor:
    """Max violation of the q-triangle inequality over all triples:
    ``max_ij D[i,j] - min_z combine(D[i,z], D[z,j])``, 0 (up to fp slack)
    iff D is a q-metric.  Finite q works in the normalised power domain.

    The bound pairs D[i, z] with D[z, j].  The JAX package's version
    (``repro/core/qmetric.py:303``) pairs D[i, z] with D[i, j] and so
    returns 0 for any matrix with a zero diagonal; see ROADMAP Queue 3."""
    if math.isinf(q):
        bound = torch.amin(torch.maximum(D[:, :, None], D[None, :, :]), dim=1)
        return (D - bound).max()
    finite = torch.where(torch.isfinite(D), D, torch.zeros_like(D))
    scale = finite.max().clamp_min(1e-30)
    P = (D / scale) ** q
    bound = torch.amin(P[:, :, None] + P[None, :, :], dim=1)
    return (P - bound).max()


def is_q_metric(D: torch.Tensor, q: float, *, tol: float = 1e-5) -> bool:
    return bool(q_violation(D, q) <= tol)
