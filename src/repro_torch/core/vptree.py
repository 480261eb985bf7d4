"""Vantage-point trees for q-metric / infinity-metric search (paper App.
C/D) — port of ``repro.core.vptree``.

Build (host, numpy): ``build_vptree`` (Algorithm 1) and ``flatten_vptree``
are copies of the JAX package's numpy code, so the same seed gives the same
arrays; only the final arrays become tensors on the requested device.

Search (device, torch), each over a whole query batch:
* ``descend_infty`` — the Theorem-1 single path, one gather and one batched
  distance per level.
* ``search_best_first`` — Algorithm 2 with a per-query DFS stack, a top-k
  buffer and a comparison budget; one Python iteration evaluates one node
  for every query still active (the JAX ``while_loop`` under ``vmap``).
* ``search_beam`` — the level-synchronous beam over the flattened tree
  (on the card one launch of ``kernels/beam``'s ``csrc/beam.cu`` runs every
  level of the batch, a block per query; on the CPU ``beam_levels``, the
  written-out (B, W) tensor ops per level), then one gathered bucket scan;
  the level loop is the ``traversal`` span (``mode="beam"``) and the scan
  and its merge the ``bucket_scan`` span (``core/telemetry``), each
  synchronised at its close only while telemetry is on.
Selections use stable sorts, which keep ``lax.top_k``'s lowest-index tie
order.

Searches take raw vectors (``X`` given, distances by the metric's pair
form) or precomputed query->dataset distance rows (``X=None``).
"""
from __future__ import annotations

import math
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import metrics as metrics_lib
from repro_torch.core import telemetry as telem
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.beam import beam as beam_lib

INF = float("inf")


class VPTree(NamedTuple):
    """Flat array representation of a VP tree."""

    vantage: torch.Tensor  # (num_nodes,) int32 — dataset index of the vantage
    mu: torch.Tensor  # (num_nodes,) float32 — node radius
    left: torch.Tensor  # (num_nodes,) int32 — inside child or -1
    right: torch.Tensor  # (num_nodes,) int32 — outside child or -1
    depth: int

    @property
    def num_nodes(self) -> int:
        return int(self.vantage.shape[0])


# ---------------------------------------------------------------------------
# host-side numpy distance rows (build-time only)
# ---------------------------------------------------------------------------

def _np_dist_rows(X: np.ndarray, i: int, idxs: np.ndarray, metric: str) -> np.ndarray:
    x = X[i]
    Y = X[idxs]
    if metric == "euclidean":
        return np.sqrt(np.maximum(((Y - x) ** 2).sum(-1), 0.0))
    if metric == "sqeuclidean":
        return ((Y - x) ** 2).sum(-1)
    if metric == "manhattan":
        return np.abs(Y - x).sum(-1)
    if metric == "chebyshev":
        return np.abs(Y - x).max(-1)
    if metric == "cosine":
        nx = max(float(np.linalg.norm(x)), 1e-12)
        ny = np.maximum(np.linalg.norm(Y, axis=-1), 1e-12)
        return 1.0 - (Y @ x) / (ny * nx)
    if metric == "correlation":
        xc = x - x.mean()
        Yc = Y - Y.mean(-1, keepdims=True)
        nx = max(float(np.linalg.norm(xc)), 1e-12)
        ny = np.maximum(np.linalg.norm(Yc, axis=-1), 1e-12)
        return 1.0 - (Yc @ xc) / (ny * nx)
    if metric == "jaccard":
        xb = x > 0
        Yb = Y > 0
        inter = (Yb & xb).sum(-1)
        union = (Yb | xb).sum(-1)
        return 1.0 - inter / np.maximum(union, 1)
    if metric == "dot":
        return -(Y @ x)
    raise KeyError(metric)


# ---------------------------------------------------------------------------
# build (Algorithm 1) — host numpy, identical to the JAX package's
# ---------------------------------------------------------------------------

def build_vptree(
    X: Optional[np.ndarray] = None,
    *,
    D: Optional[np.ndarray] = None,
    metric: str = "euclidean",
    seed: int = 0,
    select: str = "random",
    device: DeviceLike = None,
) -> VPTree:
    """Recursive median-split construction (Algorithm 1) over ``X``
    (vectors + metric) or ``D`` (a precomputed (n, n) dissimilarity);
    ``select='spread'`` uses the Yianilos variance heuristic.  The arrays
    land on ``device`` (default CUDA)."""
    if (X is None) == (D is None):
        raise ValueError("exactly one of X / D must be provided")
    dev = resolve_device(device)
    n = (X.shape[0] if X is not None else D.shape[0])
    if n == 0:
        raise ValueError("empty dataset")
    rng = np.random.default_rng(seed)

    def dist_rows(i: int, idxs: np.ndarray) -> np.ndarray:
        if D is not None:
            return np.asarray(D)[i, idxs]
        return _np_dist_rows(np.asarray(X), i, idxs, metric)

    vantage: list[int] = []
    mu: list[float] = []
    left: list[int] = []
    right: list[int] = []

    def new_node() -> int:
        vantage.append(-1)
        mu.append(0.0)
        left.append(-1)
        right.append(-1)
        return len(vantage) - 1

    max_depth = 0
    root = new_node()
    stack: list[tuple[int, np.ndarray, int]] = [(root, np.arange(n), 0)]
    while stack:
        node, idxs, d_level = stack.pop()
        max_depth = max(max_depth, d_level)
        if select == "spread" and len(idxs) > 2:
            cand = idxs[rng.choice(len(idxs), size=min(8, len(idxs)), replace=False)]
            probe = idxs[rng.choice(len(idxs), size=min(32, len(idxs)), replace=False)]
            spreads = [float(np.var(dist_rows(int(c), probe))) for c in cand]
            v = int(cand[int(np.argmax(spreads))])
        else:
            v = int(idxs[rng.integers(len(idxs))])
        rest = idxs[idxs != v]
        vantage[node] = v
        if rest.size == 0:
            continue
        dists = dist_rows(v, rest)
        m = float(np.median(dists))
        mu[node] = m
        inside = rest[dists < m]
        outside = rest[dists >= m]  # ties -> outside (paper (5))
        if inside.size:
            c = new_node()
            left[node] = c
            stack.append((c, inside, d_level + 1))
        if outside.size:
            c = new_node()
            right[node] = c
            stack.append((c, outside, d_level + 1))

    return VPTree(
        vantage=torch.as_tensor(np.asarray(vantage, np.int32), device=dev),
        mu=torch.as_tensor(np.asarray(mu, np.float32), device=dev),
        left=torch.as_tensor(np.asarray(left, np.int32), device=dev),
        right=torch.as_tensor(np.asarray(right, np.int32), device=dev),
        depth=max_depth + 1,
    )


# ---------------------------------------------------------------------------
# distance evaluation during search
# ---------------------------------------------------------------------------

def _dist(Q: torch.Tensor, X: Optional[torch.Tensor], j: torch.Tensor,
          metric: str) -> torch.Tensor:
    """Distances of each query row to dataset points ``j`` (B, ...): the
    metric's pair form against ``X[j]``, or a gather from precomputed rows
    when ``X`` is None."""
    if X is None:
        return Q.gather(1, j.reshape(Q.shape[0], -1)).reshape(j.shape)
    q = Q.reshape(Q.shape[:1] + (1,) * (j.dim() - 1) + Q.shape[1:])
    return metrics_lib.pair_fn(metric)(q, X[j])


# ---------------------------------------------------------------------------
# infinity-metric descent (Theorem 1)
# ---------------------------------------------------------------------------

def descend_infty(
    tree: VPTree,
    queries: torch.Tensor,
    *,
    X: Optional[torch.Tensor] = None,
    metric: str = "euclidean",
):
    """Single-path descent (Algorithm 3 / Theorem 1).  ``queries`` (B, d)
    vectors with ``X``, else (B, n) distance rows.  Returns (best_idx (B,)
    int32, best_dist (B,), comparisons (B,) int32); comparisons <= depth."""
    B = queries.shape[0]
    dev = queries.device
    vantage, mu = tree.vantage.long(), tree.mu
    left, right = tree.left.long(), tree.right.long()
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    best_d = torch.full((B,), INF, device=dev)
    best_i = torch.full((B,), -1, dtype=torch.int64, device=dev)
    comps = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(tree.depth):
        valid = node >= 0
        ns = node.clamp_min(0)
        j = vantage[ns]
        d = _dist(queries, X, j, metric)
        better = valid & (d < best_d)
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, j, best_i)
        comps = comps + valid.int()
        nxt = torch.where(d < mu[ns], left[ns], right[ns])
        node = torch.where(valid, nxt, node)
    return best_i.int(), best_d, comps


# ---------------------------------------------------------------------------
# finite-q best-first search (Algorithm 2) with comparison budget
# ---------------------------------------------------------------------------

def _prune_rules(d, m, tau, q_inf: bool, q: float):
    """(prune_out, prune_in): the (q-CI)/(q-CO) conditions, powered in a
    normalised domain for finite q (overflow-safe and conservative)."""
    if q_inf:
        return torch.maximum(d, tau) < m, torch.maximum(m, tau) <= d
    finite_tau = torch.isfinite(tau)
    s = torch.maximum(torch.maximum(d, m), torch.where(finite_tau, tau, 0.0))
    s = s.clamp_min(1e-30)
    dq = (d / s) ** q
    mq = (m / s) ** q
    tq = torch.where(finite_tau, (tau / s) ** q, INF)
    return dq + tq < mq, mq + tq <= dq


def search_best_first(
    tree: VPTree,
    queries: torch.Tensor,
    *,
    q: float,
    k: int = 1,
    X: Optional[torch.Tensor] = None,
    metric: str = "euclidean",
    max_comparisons: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,
    with_truncated: bool = False,
):
    """Algorithm 2: best-first q-metric VP search with top-k results.

    ``max_comparisons >= num_nodes`` gives the exact search; smaller budgets
    truncate the DFS.  ``valid`` (n,) bool restricts the RESULTS to passing
    points (every evaluated node still counts).  Returns (idx (B, k) int32,
    dist (B, k), comparisons (B,) int32) and, with ``with_truncated``, a
    (B,) bool of queries whose stack (capacity 2*depth+8) dropped a push."""
    budget = tree.num_nodes if max_comparisons is None else int(max_comparisons)
    cap = 2 * tree.depth + 8
    k = int(k)
    B = queries.shape[0]
    dev = queries.device
    q_inf = math.isinf(q)
    vantage, mu = tree.vantage.long(), tree.mu
    left, right = tree.left.long(), tree.right.long()
    rows = torch.arange(B, device=dev)

    stack = torch.zeros((B, cap), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    kd = torch.full((B, k), INF, device=dev)
    ki = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    comps = torch.zeros(B, dtype=torch.int64, device=dev)
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)

    def push(stack, sp, child, ok):
        room = sp < cap
        do = ok & room
        slot = sp.clamp_max(cap - 1)
        stack[rows, slot] = torch.where(do, child, stack[rows, slot])
        return stack, sp + do.long(), ok & ~room

    while True:
        active = (sp > 0) & (comps < budget)
        if not bool(active.any()):
            break
        node = stack[rows, (sp - 1).clamp_min(0)]
        sp = sp - active.long()
        j = vantage[node]
        d = _dist(queries, X, j, metric)
        comps = comps + active.long()
        if valid is None:
            ins_d, ins_i = d, j
        else:
            ok = valid[j]
            ins_d = torch.where(ok, d, INF)
            ins_i = torch.where(ok, j, -1)
        cd = torch.cat([kd, ins_d[:, None]], dim=1)
        ci = torch.cat([ki, ins_i[:, None]], dim=1)
        order = torch.sort(cd, dim=1, stable=True).indices[:, :k]
        kd = torch.where(active[:, None], cd.gather(1, order), kd)
        ki = torch.where(active[:, None], ci.gather(1, order), ki)
        tau = kd[:, k - 1]

        m = mu[node]
        lc, rc = left[node], right[node]
        prune_out, prune_in = _prune_rules(d, m, tau, q_inf, q)
        # DFS order: push the deferred far child first, the near child last
        push_left = (lc >= 0) & ~prune_in & active
        push_right = (rc >= 0) & ~prune_out & active
        near_left = d < m
        first = torch.where(near_left, rc, lc)
        first_ok = torch.where(near_left, push_right, push_left)
        second = torch.where(near_left, lc, rc)
        second_ok = torch.where(near_left, push_left, push_right)
        # a push past the capacity is dropped and reported, never written
        stack, sp, lost1 = push(stack, sp, first, first_ok)
        stack, sp, lost2 = push(stack, sp, second, second_ok)
        trunc = trunc | lost1 | lost2
    out = (ki.int(), kd, comps.int())
    return out + (trunc,) if with_truncated else out


# ---------------------------------------------------------------------------
# flattened tree + level-synchronous beam search
# ---------------------------------------------------------------------------

class FlatVPTree(NamedTuple):
    """Level-order flattening of a ``VPTree`` with bucketed leaves (see the
    JAX package's ``FlatVPTree``).  Child pointers: ``>= 0`` internal node,
    ``-1`` none, ``<= -2`` leaf bucket ``b`` as ``-(b + 2)``."""

    mu: torch.Tensor  # (N,) float32
    child_in: torch.Tensor  # (N,) int32
    child_out: torch.Tensor  # (N,) int32
    rad_in: torch.Tensor  # (N,) f32
    rad_out: torch.Tensor  # (N,) f32
    bucket_rows: torch.Tensor  # (num_buckets, leaf_size) int32, -1 pad
    centroids: Optional[torch.Tensor]  # (num_buckets, dim) f32
    perm: torch.Tensor  # (n,) int32 — layout row -> original dataset id
    depth: int
    leaf_size: int

    @property
    def num_nodes(self) -> int:
        return int(self.mu.shape[0])

    @property
    def num_buckets(self) -> int:
        return int(self.bucket_rows.shape[0])


def flatten_vptree(
    tree: VPTree,
    *,
    leaf_size: int = 16,
    Z: Optional[np.ndarray] = None,
    metric: str = "euclidean",
) -> FlatVPTree:
    """Build-time flattening (host numpy, identical to the JAX package's):
    collapse every subtree of at most ``leaf_size`` points into a leaf
    bucket, renumber the surviving internal nodes level-order, emit the
    bucket-major corpus permutation, and — with ``Z`` — the subtree radii
    and bucket centroids.  The arrays land on the tree's device."""
    dev = tree.vantage.device
    van = tree.vantage.cpu().numpy()
    mu_a = tree.mu.cpu().numpy()
    left = tree.left.cpu().numpy()
    right = tree.right.cpu().numpy()
    nn = van.shape[0]
    L = int(leaf_size)
    if L < 1:
        raise ValueError(f"leaf_size must be >= 1, got {leaf_size}")

    size = np.ones(nn, np.int64)
    for i in range(nn - 1, -1, -1):
        for c in (left[i], right[i]):
            if c >= 0:
                size[i] += size[c]
    collapse = size <= L
    collapse[0] = False

    order: list[int] = []
    newid: dict[int, int] = {}
    levels: list[int] = []
    queue: list[tuple[int, int]] = [(0, 0)]
    head = 0
    while head < len(queue):
        o, lvl = queue[head]
        head += 1
        newid[o] = len(order)
        order.append(o)
        levels.append(lvl)
        for c in (left[o], right[o]):
            if c >= 0 and not collapse[c]:
                queue.append((int(c), lvl + 1))
    N = len(order)
    depth = levels[-1] + 1

    def subtree_points(r: int) -> list[int]:
        out, st = [], [r]
        while st:
            x = st.pop()
            out.append(int(van[x]))
            for c in (left[x], right[x]):
                if c >= 0:
                    st.append(int(c))
        return out

    child_in = np.full(N, -1, np.int32)
    child_out = np.full(N, -1, np.int32)
    rad_in = np.full(N, np.inf, np.float32)
    rad_out = np.full(N, np.inf, np.float32)
    Za = None if Z is None else np.asarray(Z)
    buckets: list[list[int]] = []
    for o in order:
        ni = newid[o]
        for arr, rad, c in (
            (child_in, rad_in, left[o]),
            (child_out, rad_out, right[o]),
        ):
            if c < 0:
                continue
            members = subtree_points(int(c))
            if Za is not None:
                rad[ni] = float(
                    _np_dist_rows(
                        Za, int(van[o]), np.asarray(members, np.int64), metric
                    ).max()
                )
            if collapse[c]:
                arr[ni] = -(len(buckets) + 2)
                buckets.append(members)
            else:
                arr[ni] = newid[int(c)]

    perm = [int(van[o]) for o in order]
    bucket_rows = np.full((max(len(buckets), 1), L), -1, np.int32)
    centroids = None
    if Za is not None:
        centroids = np.zeros((max(len(buckets), 1), Za.shape[1]), np.float32)
    row = N
    for b, members in enumerate(buckets):
        bucket_rows[b, : len(members)] = np.arange(
            row, row + len(members), dtype=np.int32
        )
        if centroids is not None:
            centroids[b] = Za[members].mean(0)
        perm.extend(members)
        row += len(members)
    if len(perm) != nn:
        raise AssertionError(f"layout covers {len(perm)} of {nn} points")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return FlatVPTree(
        mu=t(mu_a[order].astype(np.float32)),
        child_in=t(child_in),
        child_out=t(child_out),
        rad_in=t(rad_in),
        rad_out=t(rad_out),
        bucket_rows=t(bucket_rows),
        centroids=None if centroids is None else t(centroids),
        perm=t(np.asarray(perm, np.int32)),
        depth=depth,
        leaf_size=L,
    )


def _pow2floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _hofloor(x: int) -> int:
    """Largest half-octave value (2^j or 3 * 2^(j-1)) <= x."""
    p = _pow2floor(x)
    return p + p // 2 if x >= p + p // 2 else p


def beam_plan(
    max_comparisons: Optional[int],
    *,
    depth: int,
    leaf_size: int,
    num_nodes: int,
    num_buckets: int,
    k: int,
) -> tuple[int, int]:
    """Map a per-query comparison budget onto the beam's two knobs
    ``(beam_width W, bucket_cap Bcap)`` — the JAX package's plan, verbatim:
    exact traversal accounting, W power-of-two, Bcap half-octave, full
    coverage when there is no budget."""
    from repro_torch.core.scan import pow2ceil

    levels = max(int(depth), 1)
    L = max(int(leaf_size), 1)
    nb = max(int(num_buckets), 1)
    full = num_nodes + nb + nb * L
    budget = full if max_comparisons is None else max(int(max_comparisons), 1)

    def traversal_cost(w: int) -> int:
        vant = sum(min(1 << min(lvl, 62), w) for lvl in range(levels))
        vant = min(vant, max(num_nodes, 1))
        return vant + min(2 * vant, nb)

    W = min(64, pow2ceil(max(num_nodes, 1)))
    while W > 1 and traversal_cost(W) > budget // 2:
        W //= 2
    rem = max(budget - traversal_cost(W), L)
    Bcap = nb if rem // L >= nb else _hofloor(rem // L)
    need = -(-int(k) // L)
    return W, min(max(Bcap, pow2ceil(need)), nb)


def _smallest(vals: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``count`` smallest entries of each row and their positions,
    ties to the lowest position (``lax.top_k`` on the negated row)."""
    order = torch.sort(vals, dim=1, stable=True).indices[:, :count]
    return vals.gather(1, order), order


def _merge(best_d, best_i, ds, ids, K: int):
    """The K smallest of a running best list and new entries, the list's
    entries first on ties."""
    cd = torch.cat([best_d, ds], dim=1)
    ci = torch.cat([best_i, ids], dim=1)
    vals, pos = _smallest(cd, K)
    return vals, ci.gather(1, pos)


def _point_dists(queries, X, perm, pair, rows: torch.Tensor) -> torch.Tensor:
    """Distances of each query to layout rows ``rows`` (B, R): vector mode
    reads X[rows], rows mode the query's precomputed distance to the row's
    original id."""
    if X is None:
        return queries.gather(1, perm[rows])
    return pair(queries[:, None, :], X[rows])


def beam_levels(
    flat: FlatVPTree,
    queries: torch.Tensor,
    *,
    q: float,
    k: int,
    beam_width: int,
    bucket_cap: int,
    X: Optional[torch.Tensor] = None,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
):
    """The ``flat.depth`` levels of the beam over the flattened tree
    ``flat`` for every query: ``X`` is the layout-ordered corpus (vector
    mode: distances by the metric's pair form, buckets ranked by their
    centroid distance); with ``X=None`` each query is a precomputed (n,)
    row indexed by original id (rows mode: buckets ranked by priority).
    ``valid`` (n,) bool, by original id, masks acceptance only.

    Returns ``(best_d (B, K) f32, best_i (B, K) int64, buf (B, Bcap) int64,
    c_trav (B,) int64, c_cent (B,) int64)``: each query's K best vantages by
    distance, ascending ((+inf, -1) past those found), its Bcap selected
    leaf buckets (-1 past those found), the vantages it scored and the
    centroids it ranked.  ``search_beam`` runs this on the CPU; on the card
    ``kernels/beam``'s kernel computes the same, and this is its plain
    version."""
    W, Bcap, K = int(beam_width), int(bucket_cap), int(k)
    B = queries.shape[0]
    dev = queries.device
    q_inf = math.isinf(q)
    mu, perm = flat.mu, flat.perm.long()
    child_in, child_out = flat.child_in.long(), flat.child_out.long()
    rad_in, rad_out = flat.rad_in, flat.rad_out
    centroids = flat.centroids if X is not None else None
    pair = None if X is None else metrics_lib.pair_fn(metric)

    frontier = torch.full((B, W), -1, dtype=torch.int64, device=dev)
    frontier[:, 0] = 0
    flb = torch.zeros((B, W), device=dev)
    best_d = torch.full((B, K), INF, device=dev)
    best_i = torch.full((B, K), -1, dtype=torch.int64, device=dev)
    buf = torch.full((B, Bcap), -1, dtype=torch.int64, device=dev)
    bufp = torch.full((B, Bcap), INF, device=dev)
    c_trav = torch.zeros(B, dtype=torch.int64, device=dev)
    c_cent = torch.zeros(B, dtype=torch.int64, device=dev)

    for _ in range(flat.depth):
        alive = frontier >= 0
        nid = frontier.clamp_min(0)
        d = torch.where(alive, _point_dists(queries, X, perm, pair, nid), INF)
        c_trav = c_trav + alive.sum(1)
        # the vantages are dataset points: merge them before pruning
        vid = perm[nid]
        acc = alive if valid is None else alive & valid[vid]
        best_d, best_i = _merge(best_d, best_i, torch.where(acc, d, INF),
                                torch.where(acc, vid, -1), K)
        tau = best_d[:, K - 1:K]

        m = mu[nid]
        prune_out, prune_in = _prune_rules(d, m, tau, q_inf, q)
        keep_in_c, keep_out_c = ~prune_in, ~prune_out
        cin, cout = child_in[nid], child_out[nid]
        ptr = torch.cat([cin, cout], dim=1)
        keep = torch.cat([alive & (cin != -1) & keep_in_c,
                          alive & (cout != -1) & keep_out_c], dim=1)
        # beam priority: (accumulated path bound, parent distance), with
        # the subtree radii tightening the 1-triangle bounds (see the JAX
        # package's _beam_impl for the argument)
        rin = torch.where(torch.isfinite(rad_in[nid]), rad_in[nid], m)
        rout = rad_out[nid]
        lb = torch.cat([(d - rin).clamp_min(0.0),
                        torch.maximum(m - d, d - rout).clamp_min(0.0)], dim=1)
        bound = torch.maximum(torch.cat([flb, flb], dim=1), lb)
        prio = torch.where(keep, bound * 1024.0 + torch.cat([d, d], dim=1), INF)

        # reached leaf buckets: running top-Bcap by priority (query ->
        # centroid distance in vector mode, each one counted)
        is_bucket = keep & (ptr <= -2)
        if centroids is not None:
            bidx = torch.where(is_bucket, -(ptr + 2), 0)
            dcent = pair(queries[:, None, :], centroids[bidx])
            bprio = torch.where(is_bucket, dcent, INF)
            c_cent = c_cent + is_bucket.sum(1)
        else:
            bprio = torch.where(is_bucket, prio, INF)
        cat_p = torch.cat([bufp, bprio], dim=1)
        cat_b = torch.cat([buf, -(ptr + 2)], dim=1)
        bufp, bpos = _smallest(cat_p, Bcap)
        buf = torch.where(torch.isfinite(bufp), cat_b.gather(1, bpos), -1)

        # next frontier: the W most promising surviving internal children
        nprio, pos = _smallest(torch.where(keep & (ptr >= 0), prio, INF), W)
        sel = torch.isfinite(nprio)
        frontier = torch.where(sel, ptr.gather(1, pos), -1)
        flb = torch.where(sel, bound.gather(1, pos), 0.0)
    return best_d, best_i, buf, c_trav, c_cent


def search_beam(
    flat: FlatVPTree,
    queries: torch.Tensor,
    *,
    q: float,
    k: int = 1,
    X: Optional[torch.Tensor] = None,
    metric: str = "euclidean",
    max_comparisons: Optional[int] = None,
    beam_width: Optional[int] = None,
    bucket_cap: Optional[int] = None,
    valid: Optional[torch.Tensor] = None,
    codes: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    with_stages: bool = False,
):
    """Level-synchronous beam search over a flattened VP tree for a whole
    query batch.

    ``X`` is the LAYOUT-ORDERED corpus (``Z[flat.perm]``); with ``X=None``
    each query is a precomputed (n,) row indexed by ORIGINAL id.
    ``codes``/``scales`` (int8 codes of the layout-ordered corpus and their
    per-dimension scales) switch the bucket scans to dequantised code rows;
    the traversal stays f32, because navigation errors compound down the
    tree.
    ``max_comparisons`` is a plan (``beam_plan``; explicit knobs win).
    Returns (idx (B, k) int32 original ids, dist (B, k), comparisons (B,)
    int32) and, with ``with_stages``, a dict of (B,) int32 counters
    ``{"traversal", "centroid_rank", "bucket_scan"}`` summing to
    ``comparisons``."""
    if codes is not None and X is None:
        raise ValueError("quantized bucket scan requires vector mode (X)")
    W0, B0 = beam_plan(
        max_comparisons, depth=flat.depth, leaf_size=flat.leaf_size,
        num_nodes=flat.num_nodes, num_buckets=flat.num_buckets, k=k,
    )
    W = max(1, int(beam_width) if beam_width is not None else W0)
    Bcap = max(1, min(int(bucket_cap) if bucket_cap is not None else B0,
                      flat.num_buckets))
    K = int(k)
    B = queries.shape[0]
    dev = queries.device
    perm = flat.perm.long()
    bucket_rows = flat.bucket_rows.long()
    pair = None if X is None else metrics_lib.pair_fn(metric)

    with telem.span("traversal", engine="infinity", mode="beam", sync=dev):
        levels = beam_lib.beam_cuda if queries.is_cuda else beam_levels
        best_d, best_i, buf, c_trav, c_cent = levels(
            flat, queries, q=q, k=K, beam_width=W, bucket_cap=Bcap, X=X,
            metric=metric, valid=valid)
    with telem.span("bucket_scan", engine="infinity", mode="beam", sync=dev):
        # one gathered scan over every selected bucket
        rows = torch.where((buf >= 0)[:, :, None], bucket_rows[buf.clamp_min(0)], -1)
        rows = rows.reshape(B, -1)
        rvalid = rows >= 0
        rsafe = rows.clamp_min(0)
        if codes is None:
            d = _point_dists(queries, X, perm, pair, rsafe)
        else:
            d = pair(queries[:, None, :], codes[rsafe].float() * scales)
        d = torch.where(rvalid, d, INF)
        oid = perm[rsafe]
        c_buck = rvalid.sum(1)
        acc = rvalid if valid is None else rvalid & valid[oid]
        best_d, best_i = _merge(best_d, best_i, torch.where(acc, d, INF),
                                torch.where(acc, oid, -1), K)
    comps = (c_trav + c_cent + c_buck).int()
    out = (best_i.int(), best_d, comps)
    if with_stages:
        stages = {"traversal": c_trav.int(), "centroid_rank": c_cent.int(),
                  "bucket_scan": c_buck.int()}
        return out + (stages,)
    return out


# ---------------------------------------------------------------------------
# reference search (host, exact recursion) — oracle for tests
# ---------------------------------------------------------------------------

def search_reference(
    tree: VPTree,
    q_row_or_vec: np.ndarray,
    *,
    q: float,
    X: Optional[np.ndarray] = None,
    metric: str = "euclidean",
) -> tuple[int, float, int]:
    """Literal recursive Algorithm 2/3 in numpy (1 query, k=1)."""
    vantage = tree.vantage.cpu().numpy()
    mu = tree.mu.cpu().numpy()
    left = tree.left.cpu().numpy()
    right = tree.right.cpu().numpy()

    if X is None:
        def dist(j: int) -> float:
            return float(q_row_or_vec[j])
    else:
        Xq = np.concatenate([np.asarray(X), np.asarray(q_row_or_vec)[None]], axis=0)

        def dist(j: int) -> float:
            return float(_np_dist_rows(Xq, Xq.shape[0] - 1, np.asarray([j]), metric)[0])

    best = [-1, math.inf, 0]  # idx, tau, comparisons

    def visit(node: int) -> None:
        if node < 0:
            return
        j = int(vantage[node])
        d = dist(j)
        best[2] += 1
        if d < best[1]:
            best[1] = d
            best[0] = j
        tau = best[1]
        m = float(mu[node])
        if math.isinf(q):
            if d < m:
                visit(int(left[node]))
                if not max(d, tau) < m:  # unreachable: complementary conditions
                    visit(int(right[node]))
            else:
                visit(int(right[node]))
            return
        s = max(d, m, 0.0 if math.isinf(tau) else tau, 1e-30)
        dq, mq = (d / s) ** q, (m / s) ** q
        tq = math.inf if math.isinf(tau) else (tau / s) ** q
        if dq + tq < mq:
            visit(int(left[node]))
        elif mq + tq <= dq:
            visit(int(right[node]))
        else:
            if d < m:
                visit(int(left[node]))
                visit(int(right[node]))
            else:
                visit(int(right[node]))
                visit(int(left[node]))

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, tree.num_nodes + 100))
    try:
        visit(0)
    finally:
        sys.setrecursionlimit(old)
    return best[0], best[1], best[2]
