"""The plain reference of the index build's sparse canonical q-projection,
in float64.

Plain PyTorch only; it imports nothing of the program.  Given the (n, n)
dissimilarity D of the projection's subset and the boolean kNN-and-links
mask, it computes what the build defines (paper §3, Algs. 6/7, the
doubling schedule):

* the edges are the mask, symmetrised, and the diagonal;
* finite q works on the edges' powers ``D^q`` in the (min, +) semiring, so
  a path's length is the sum of its edges' powers; q = inf works on D in
  (min, max);
* ``M <- min(M, M (x) M)`` ``num_hops`` times, so after the last product
  ``M`` is the shortest over paths of at most ``2^num_hops`` edges;
* pairs no such path joins stay +inf; finite q returns ``M^(1/q)``.

The program works in another domain (``q log D`` with a log-sum-exp
combine, on the qpath kernel); the two meet only in the answer.  The
products run over blocks of rows so that a 2 048-point subset fits.
"""
from __future__ import annotations

import torch

#: rows of the left operand per block of a semiring product
ROW_BLOCK = 16


def semiring_product(A: torch.Tensor, B: torch.Tensor, *, tropical_max: bool) -> torch.Tensor:
    """``C[i, j] = min_l A[i, l] + B[l, j]`` (``tropical_max``: ``max``
    in place of ``+``), over blocks of ``ROW_BLOCK`` rows."""
    out = torch.empty((A.shape[0], B.shape[1]), dtype=A.dtype, device=A.device)
    for lo in range(0, A.shape[0], ROW_BLOCK):
        a = A[lo:lo + ROW_BLOCK, :, None]
        paths = torch.maximum(a, B[None]) if tropical_max else a + B[None]
        out[lo:lo + ROW_BLOCK] = paths.amin(dim=1)
    return out


def sparse_projection(D: torch.Tensor, mask: torch.Tensor, q: float, *,
                      num_hops: int = 6) -> torch.Tensor:
    """The projected (n, n) distances, float64: ``D`` the subset's
    dissimilarities (zero diagonal), ``mask`` the boolean adjacency."""
    n = D.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    edges = mask | mask.T | eye
    D = D.double()
    inf = q == float("inf")
    M = torch.where(edges, D if inf else D.pow(q), torch.full_like(D, float("inf")))
    for _ in range(num_hops):
        M = torch.minimum(M, semiring_product(M, M, tropical_max=inf))
    return M if inf else M.pow(1.0 / q)
