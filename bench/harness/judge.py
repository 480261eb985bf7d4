"""Whether the answers are right: the program's answers of the window set
against the plain reference (``bench/reference``), number by number.

The numbers compared (each against the limit the configuration states):

* ``bad_answers``: answers that hold an id the index should not hold
  (out of range, deleted), an id twice, a -1 where alive rows are left, or
  distances out of ascending order.  Limit 0.
* ``dist_err``: the widest relative gap between a distance returned and
  the reference's float64 distance for that (query, id).
* ``rank_gap`` (exact configurations): the widest relative gap by which
  the reference distance of the j-th id returned lies above the exact j-th
  distance.
* ``recall_loss`` (approximate configurations): one less the mean overlap
  of each answer's ids with the exact top k.  The distances of an
  approximate engine's answers are re-scored exactly, so ``dist_err``
  cannot see a traversal that finds the wrong rows; this number does.
* ``missing``: queries the window sent, and the program took, that were
  never answered (a failed batch's queries, rows left out of an answer).
  Limit 0.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.exact import exact_topk, pair_dists


def _to(dev, arr, dtype=None):
    return torch.as_tensor(arr, device=dev, dtype=dtype)


def judge(queries: torch.Tensor, rows: torch.Tensor, alive: torch.Tensor,
          qids: np.ndarray, idx: np.ndarray, dist: np.ndarray, *, k: int,
          exact: bool) -> dict:
    """The comparison numbers for answers (qids (N,), idx (N, k), dist
    (N, k)) to ``queries`` over ``rows`` (ids are row numbers), of which
    ``alive`` are in the index; ``exact``: the configuration promises the
    exact neighbours."""
    dev = rows.device
    n = rows.shape[0]
    N = qids.shape[0]
    out = {"answers": int(N)}
    if N == 0:
        return dict(out, bad_answers=0, dist_err=0.0, rank_gap=0.0, recall=None,
                    recall_loss=None)
    I = _to(dev, idx, torch.int64)
    D = _to(dev, dist, torch.float64)
    U = _to(dev, qids, torch.int64)
    in_range = (I >= 0) & (I < n)
    ok = in_range.clone()
    ok[in_range] = alive[I[in_range]]
    n_alive = int(alive.sum())
    need = min(k, n_alive)
    bad = (~ok[:, :need]).any(1) | ((I[:, need:] != -1) & ~ok[:, need:]).any(1)
    srt = torch.sort(I, dim=1).values
    bad |= ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(1)
    fin = torch.where(ok, D, torch.full_like(D, float("inf")))
    bad |= (fin[:, 1:] < fin[:, :-1]).any(1)
    out["bad_answers"] = int(bad.sum())

    qr = U[:, None].expand_as(I)[ok]
    ref = pair_dists(queries, rows, qr, I[ok])
    got = D[ok]
    err = (got - ref).abs() / ref.clamp_min(1e-30)
    out["dist_err"] = float(err.max()) if err.numel() else 0.0

    uniq, inv = torch.unique(U, return_inverse=True)
    ex_d, ex_i = exact_topk(queries[uniq], rows, k=k, alive=alive)
    ex_d, ex_i = ex_d[inv], ex_i[inv]
    hit = (I[:, :, None] == ex_i[:, None, :]) & ok[:, :, None]
    out["recall"] = float(hit.any(2).sum(1).double().mean() / k)
    out["recall_loss"] = 1.0 - out["recall"]
    if exact:
        refd = torch.full(I.shape, float("inf"), dtype=torch.float64, device=dev)
        refd[ok] = ref
        refd = torch.sort(refd, dim=1).values[:, :need]
        gap = (refd - ex_d[:, :need].double()) / ex_d[:, :need].double().clamp_min(1e-30)
        gap = torch.where(torch.isfinite(gap), gap, torch.zeros_like(gap))
        out["rank_gap"] = float(gap.max())
    return out


def control_answers(queries: torch.Tensor, rows: torch.Tensor, alive: torch.Tensor,
                    qids: np.ndarray, *, k: int):
    """The control put in the program's place: the exact answers computed
    in TF32, as (idx, dist) host arrays for ``qids``."""
    dev = rows.device
    U = _to(dev, qids, torch.int64)
    uniq, inv = torch.unique(U, return_inverse=True)
    d, i = exact_topk(queries[uniq], rows, k=k, alive=alive, precision="tf32")
    return i[inv].cpu().numpy(), d[inv].float().cpu().numpy()


def verdict(numbers: dict, limits: dict, missing: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for ``missing`` and the
    numbers this configuration's limits name."""
    checks = {"missing": {"value": missing, "limit": 0}}
    for name, limit in limits.items():
        if name in numbers:
            checks[name] = {"value": numbers[name], "limit": limit}
    correct = numbers.get("answers", 0) > 0
    for name, c in checks.items():
        if c["value"] is None or not c["value"] <= c["limit"]:
            correct = False
    return correct, checks
