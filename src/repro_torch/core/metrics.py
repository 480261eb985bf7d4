"""Dissimilarity functions (paper §2, Table 1) — port of ``repro.core.metrics``.

Every metric has two forms, both batched over leading dimensions:
  * ``<name>(x, y)``        — pair form, reduces the last axis:
                              (..., d) x (..., d) -> (...).
  * ``<name>_matrix(X, Y)`` — matrix form: (..., m, d) x (..., n, d) ->
                              (..., m, n).

``pairwise`` is the single integration point used by the build: on a CUDA
tensor the matmul family goes to the ``kernels/pdist`` CUDA kernel; jaccard
and correlation stay plain (the JAX package has no kernel for them either).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.pdist import ops as pdist_ops

__all__ = [
    "EPS", "METRICS",
    "euclidean", "sqeuclidean", "manhattan", "chebyshev", "cosine",
    "correlation", "jaccard", "dot",
    "euclidean_matrix", "sqeuclidean_matrix", "manhattan_matrix",
    "chebyshev_matrix", "cosine_matrix", "correlation_matrix",
    "jaccard_matrix", "dot_matrix",
    "pair_fn", "matrix_fn", "pairwise",
]

EPS = 1e-12

# ---------------------------------------------------------------------------
# pair forms
# ---------------------------------------------------------------------------


def euclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(((x - y) ** 2).sum(-1).clamp_min(0.0))


def sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).sum(-1)


def manhattan(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().sum(-1)


def chebyshev(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().amax(-1)


def cosine(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    nx = torch.sqrt((x * x).sum(-1))
    ny = torch.sqrt((y * y).sum(-1))
    return 1.0 - (x * y).sum(-1) / (nx * ny).clamp_min(EPS)


def correlation(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return cosine(x - x.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True))


def jaccard(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jaccard dissimilarity for binary (0/1) vectors."""
    xb, yb = x > 0, y > 0
    inter = (xb & yb).sum(-1).float()
    union = (xb | yb).sum(-1).float()
    return 1.0 - inter / union.clamp_min(1.0)


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative inner product (maximum-inner-product search as dissimilarity)."""
    return -(x * y).sum(-1)


# ---------------------------------------------------------------------------
# matrix forms
# ---------------------------------------------------------------------------


def _mT(Y: torch.Tensor) -> torch.Tensor:
    return Y.transpose(-1, -2)


def sqeuclidean_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Squared distances via ``|x|^2 + |y|^2 - 2 x.yT`` (one matmul)."""
    x2 = (X * X).sum(-1)[..., :, None]
    y2 = (Y * Y).sum(-1)[..., None, :]
    return (x2 + y2 - 2.0 * (X @ _mT(Y))).clamp_min(0.0)


def euclidean_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sqeuclidean_matrix(X, Y))


def manhattan_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return (X[..., :, None, :] - Y[..., None, :, :]).abs().sum(-1)


def chebyshev_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return (X[..., :, None, :] - Y[..., None, :, :]).abs().amax(-1)


def cosine_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    Xn = X / torch.linalg.norm(X, dim=-1, keepdim=True).clamp_min(EPS)
    Yn = Y / torch.linalg.norm(Y, dim=-1, keepdim=True).clamp_min(EPS)
    return 1.0 - Xn @ _mT(Yn)


def correlation_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return cosine_matrix(X - X.mean(-1, keepdim=True), Y - Y.mean(-1, keepdim=True))


def jaccard_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    Xb = (X > 0).float()
    Yb = (Y > 0).float()
    inter = Xb @ _mT(Yb)
    union = Xb.sum(-1)[..., :, None] + Yb.sum(-1)[..., None, :] - inter
    return 1.0 - inter / union.clamp_min(1.0)


def dot_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    return -(X @ _mT(Y))


_PAIR: dict[str, Callable] = {
    "euclidean": euclidean,
    "sqeuclidean": sqeuclidean,
    "manhattan": manhattan,
    "chebyshev": chebyshev,
    "cosine": cosine,
    "correlation": correlation,
    "jaccard": jaccard,
    "dot": dot,
}

_MATRIX: dict[str, Callable] = {
    "euclidean": euclidean_matrix,
    "sqeuclidean": sqeuclidean_matrix,
    "manhattan": manhattan_matrix,
    "chebyshev": chebyshev_matrix,
    "cosine": cosine_matrix,
    "correlation": correlation_matrix,
    "jaccard": jaccard_matrix,
    "dot": dot_matrix,
}

METRICS = tuple(sorted(_PAIR))


def pair_fn(metric: str) -> Callable:
    if metric not in _PAIR:
        raise KeyError(f"unknown metric {metric!r}; available: {METRICS}")
    return _PAIR[metric]


def matrix_fn(metric: str) -> Callable:
    if metric not in _MATRIX:
        raise KeyError(f"unknown metric {metric!r}; available: {METRICS}")
    return _MATRIX[metric]


def pairwise(
    X: torch.Tensor, Y: torch.Tensor, *, metric: str = "euclidean", block: int = 0
) -> torch.Tensor:
    """(m, d) x (n, d) -> (m, n) dissimilarity matrix.

    Metrics with a kernel go through ``kernels/pdist`` (the CUDA kernel on
    the card, its plain version on the CPU); jaccard and correlation use
    their matrix forms.  ``block > 0`` evaluates row blocks of that size to
    bound the intermediate of the O(m n d) metrics."""
    if block and X.shape[0] > block:
        return torch.cat(
            [pairwise(X[i:i + block], Y, metric=metric)
             for i in range(0, X.shape[0], block)]
        )
    if metric in pdist_ops.SUPPORTED:
        return pdist_ops.pdist(X, Y, metric=metric)
    return matrix_fn(metric)(X.float(), Y.float())
