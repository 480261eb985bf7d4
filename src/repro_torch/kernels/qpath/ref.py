"""Plain PyTorch version of the q-path semiring matmul (the twin of
``repro.kernels.qpath.ref`` and of the row-blocked jnp path of
``repro.core.qmetric.semiring_matmul``): the CPU path and the oracle the
CUDA kernel is held to.  Rows are taken ``row_block`` at a time so the
(rows, k, n) combine intermediate stays bounded; min is exact, so the
blocking does not change the result."""
from __future__ import annotations

import torch

MODES = ("minplus", "minmax", "logminplus")


def combine(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Edge-combine along a path: sum, max, or logaddexp (log-power
    domain; ``torch.logaddexp`` agrees with ``jnp.logaddexp`` at +-inf)."""
    if mode == "logminplus":
        return torch.logaddexp(a, b)
    if mode == "minplus":
        return a + b
    if mode == "minmax":
        return torch.maximum(a, b)
    raise ValueError(f"unknown semiring mode {mode!r}")


def qpath_matmul_ref(
    A: torch.Tensor, B: torch.Tensor, *, mode: str, row_block: int = 32
) -> torch.Tensor:
    """C[i, j] = min_k combine(A[i, k], B[k, j])."""
    m, kd = A.shape
    k2, n = B.shape
    if kd != k2:
        raise ValueError(f"inner dimensions differ: {tuple(A.shape)} x {tuple(B.shape)}")
    A = A.float()
    B = B.float()
    if kd == 0:
        return torch.full((m, n), float("inf"), dtype=torch.float32, device=A.device)
    bs = max(1, min(int(row_block), max(m, 1)))
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    for start in range(0, m, bs):
        c = combine(A[start:start + bs, :, None], B[None, :, :], mode)
        out[start:start + bs] = c.amin(dim=1)
    return out
