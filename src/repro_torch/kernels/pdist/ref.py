"""Plain PyTorch version of the pairwise-distance kernel (the twin of
``repro.kernels.pdist.ref.pdist_ref``): the CPU path and the oracle the
CUDA kernel is held to."""
from __future__ import annotations

import torch

EPS = 1e-12
#: bound on the (rows, n, d) |x - y| intermediate of the cube metrics: rows
#: of X are taken in blocks that keep it under this many bytes
CUBE_BLOCK_BYTES = 1 << 28


def cube_rows(n: int, d: int) -> int:
    """Rows per block of a cube-metric matrix over n columns of width d."""
    return max(1, CUBE_BLOCK_BYTES // (4 * max(n, 1) * max(d, 1)))


def pdist_ref(X: torch.Tensor, Y: torch.Tensor, *, metric: str) -> torch.Tensor:
    X = X.float()
    Y = Y.float()
    if metric in ("sqeuclidean", "euclidean"):
        d2 = (
            (X * X).sum(-1)[:, None]
            + (Y * Y).sum(-1)[None, :]
            - 2.0 * (X @ Y.T)
        )
        d2 = d2.clamp_min(0.0)
        return d2 if metric == "sqeuclidean" else torch.sqrt(d2)
    if metric == "cosine":
        nx = torch.linalg.norm(X, dim=-1).clamp_min(EPS)
        ny = torch.linalg.norm(Y, dim=-1).clamp_min(EPS)
        return 1.0 - (X @ Y.T) / (nx[:, None] * ny[None, :])
    if metric == "dot":
        return -(X @ Y.T)
    if metric in ("manhattan", "chebyshev"):
        rows = cube_rows(Y.shape[0], Y.shape[1])
        return torch.cat([_cube(X[i:i + rows], Y, metric)
                          for i in range(0, max(X.shape[0], 1), rows)])
    raise ValueError(metric)


def _cube(X: torch.Tensor, Y: torch.Tensor, metric: str) -> torch.Tensor:
    diff = (X[:, None, :] - Y[None, :, :]).abs_()
    return diff.sum(-1) if metric == "manhattan" else diff.amax(-1)
