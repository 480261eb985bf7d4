"""The plain reference: exact euclidean k-nearest neighbours, in float64.

Plain PyTorch only.  It imports nothing of the program and takes nothing
the program made: the benchmark hands it the rows, the queries and which
rows are alive, and it works the neighbours out itself.  It runs in blocks
of queries (and of pairs), so that it fits beside nothing else once the
program's state has been freed.

``precision="tf32"`` is the control: the same search with the operands of
the cross term rounded to TF32 (10 mantissa bits, what a float32 matmul
with TF32 on reads) and float32 sums, the nearest precision below the
float32 that the configurations state.  The rounding is done by hand, so
the control reads the same on the CPU as on the card.
"""
from __future__ import annotations

import torch

#: queries per block of the exact search, and pairs per block of the
#: distance check
QUERY_BLOCK = 2048
PAIR_BLOCK = 1 << 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), kept in a
    float32 tensor."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _sq_dists(Qb: torch.Tensor, X: torch.Tensor, xsq: torch.Tensor,
              precision: str) -> torch.Tensor:
    if precision == "f64":
        Qd = Qb.double()
        cross = Qd @ X.T
        return (Qd * Qd).sum(1, keepdim=True) + xsq[None, :] - 2.0 * cross
    if precision == "tf32":
        Qf = Qb.float()
        cross = round_tf32(Qf) @ round_tf32(X).T
        return (Qf * Qf).sum(1, keepdim=True) + xsq[None, :] - 2.0 * cross
    raise ValueError(f"unknown precision {precision!r}")


def exact_topk(Q: torch.Tensor, X: torch.Tensor, *, k: int,
               alive: torch.Tensor | None = None, precision: str = "f64"):
    """The k nearest alive rows of X (n, d) for each query of Q (m, d):
    (dists (m, k) euclidean, ascending; rows (m, k) int64), in ``precision``
    (``"f64"``: the reference; ``"tf32"``: the control).  Ties go to the
    lower row."""
    Xw = X.double() if precision == "f64" else X.float()
    xsq = (Xw * Xw).sum(1)
    if alive is not None:
        xsq = torch.where(alive.to(X.device), xsq, torch.full_like(xsq, float("inf")))
    out_d, out_i = [], []
    for lo in range(0, Q.shape[0], QUERY_BLOCK):
        D2 = _sq_dists(Q[lo:lo + QUERY_BLOCK], Xw, xsq, precision)
        # a stable sort: ties to the lower row
        order = torch.sort(D2, dim=1, stable=True).indices[:, :k]
        d2 = D2.gather(1, order)
        out_d.append(d2.clamp_min(0).sqrt())
        out_i.append(order)
    return torch.cat(out_d), torch.cat(out_i)


def pair_dists(Q: torch.Tensor, X: torch.Tensor, q_rows: torch.Tensor,
               x_rows: torch.Tensor) -> torch.Tensor:
    """Euclidean distance in float64 between query ``q_rows[i]`` and row
    ``x_rows[i]``, by the difference of the two rows (no cancellation)."""
    out = []
    for lo in range(0, q_rows.shape[0], PAIR_BLOCK):
        qa = Q[q_rows[lo:lo + PAIR_BLOCK]].double()
        xa = X[x_rows[lo:lo + PAIR_BLOCK]].double()
        out.append((qa - xa).pow(2).sum(1).sqrt())
    if not out:
        return torch.zeros((0,), dtype=torch.float64, device=Q.device)
    return torch.cat(out)
