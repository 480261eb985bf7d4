"""Plain PyTorch version of the pairwise-distance kernel (the twin of
``repro.kernels.pdist.ref.pdist_ref``): the CPU path and the oracle the
CUDA kernel is held to."""
from __future__ import annotations

import torch

EPS = 1e-12


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
    if metric == "manhattan":
        return (X[:, None, :] - Y[None, :, :]).abs().sum(-1)
    if metric == "chebyshev":
        return (X[:, None, :] - Y[None, :, :]).abs().amax(-1)
    raise ValueError(metric)
