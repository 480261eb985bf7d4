"""The q = 2 cell (``fmnist784-q2-b512``) and the plain reference of the
build's projection (``bench/reference/qproject.py``).

On the CPU, at small sizes: the program's sparse canonical projection
equals the reference for q in {2, 4, inf}; on a 2-metric that the
reference projects, the beam's finite-q prune rules never drop a closer
point; the cell runs ``correct`` at the size the other cells' CPU tests
use, a traversal that finds the wrong rows is not ``correct``, its prune
rules drop nothing at the rerank's width, and ``projection_s`` reads the
build's projection stage.  On the card (``-m gpu``):
the build's projection at the cell's sizes, on the ``logminplus`` kernel,
against the reference in float64."""
import math
import time

import numpy as np
import pytest
import torch

from bench.data.manifold import manifold
from bench.harness import main, spec
from bench.reference.qproject import semiring_product, sparse_projection
from bench.tests.test_bench_correct import SMALL_INF, _wrong_rows

Q2 = "fmnist784-q2-b512"
#: finite q: the program works in float32 on ``q log d``; six hops of
#: rounding there read ~1e-6 relative (bf16 operands would read ~4e-3)
RTOL = 1e-5
SEED = 2**31 + 41


def _build_inputs(S: torch.Tensor, *, knn_k: int, links: int, rng):
    """D and the kNN-and-links mask of the subset ``S``, as
    ``InfinityIndex.build`` makes them (zero diagonal; the links drawn
    from ``rng``)."""
    from repro_torch.core import knn_graph as knn_lib
    from repro_torch.core import metrics as metrics_lib

    dev = S.device
    ns = S.shape[0]
    idx, _ = knn_lib.knn_graph(S, k=knn_k, metric="euclidean")
    mask = knn_lib.knn_mask(idx, ns)
    mask |= knn_lib.knn_mask(torch.as_tensor(rng.integers(0, ns, size=(ns, links)),
                                             device=dev), ns)
    D = metrics_lib.pairwise(S, S, metric="euclidean")
    D = torch.where(torch.eye(ns, dtype=torch.bool, device=dev), 0.0, D)
    return D, mask


def _assert_projection_matches(got: torch.Tensor, ref: torch.Tensor, q: float):
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    if math.isinf(q):
        assert torch.equal(got, ref.float())
    else:
        rel = (got.double()[fin] - ref[fin]).abs() / ref[fin].clamp_min(1e-30)
        assert float(rel.max()) <= RTOL, float(rel.max())


@pytest.mark.parametrize("q", [2.0, 4.0, math.inf], ids=["q2", "q4", "qinf"])
def test_the_projection_equals_the_plain_reference(q):
    from repro_torch.core import qmetric

    S = manifold(256, d=32, seed=SEED)
    D, mask = _build_inputs(S, knn_k=6, links=1, rng=np.random.default_rng(5))
    got = qmetric.sparse_canonical_projection(D, mask, q, num_hops=6, schedule="doubling")
    ref = sparse_projection(D, mask, q, num_hops=6)
    _assert_projection_matches(got, ref, q)
    # the projection shortened some pairs and left none of the edges longer
    edges = mask | mask.T
    assert (ref[edges] <= D.double()[edges]).all()
    assert (ref[~edges & torch.isfinite(ref)] > 0).any()


def _counting(rules, drops):
    """``_prune_rules`` that appends, at each call, how many existing
    children of alive nodes it drops (read from ``search_beam``'s frame)."""
    import sys

    def spy(d, m, tau, q_inf, q):
        out, inn = rules(d, m, tau, q_inf, q)
        caller = sys._getframe(1).f_locals
        alive, nid, flat = caller["alive"], caller["nid"], caller["flat"]
        drops.append(sum(int((alive & (child[nid] != -1) & drop).sum())
                         for child, drop in ((flat.child_in, inn), (flat.child_out, out))))
        return out, inn

    return spy


def test_the_finite_q_prune_rules_never_drop_a_closer_point(monkeypatch):
    """The beam in rows mode over a 2-metric (the reference's projection of
    512 points and 64 queries), with a beam and a bucket budget that cover
    the tree, returns each query's exact 10 nearest, and its rules pruned."""
    from repro_torch.core import vptree

    n, m, k = 512, 64, 10
    X = manifold(n + m, d=16, seed=SEED + 1)
    D, mask = _build_inputs(X, knn_k=8, links=2, rng=np.random.default_rng(6))
    P = sparse_projection(D, mask, 2.0, num_hops=10)  # paths of any length
    assert torch.isfinite(P).all()
    # a 2-metric: no pair's power above the sum of its powers through a third point
    P2 = P.pow(2)
    assert (P2 <= semiring_product(P2, P2, tropical_max=False) * (1 + 1e-12)).all()
    Pf = P.float()
    tree = vptree.build_vptree(D=Pf[:n, :n].numpy(), seed=7, device="cpu")
    flat = vptree.flatten_vptree(tree, leaf_size=8)
    rows = Pf[n:, :n]
    drops = []
    monkeypatch.setattr(vptree, "_prune_rules", _counting(vptree._prune_rules, drops))
    idx, dist, comps = vptree.search_beam(flat, rows, q=2.0, k=k, beam_width=flat.num_nodes,
                                         bucket_cap=flat.num_buckets)
    pruned = sum(drops)
    want = torch.sort(rows, dim=1).values[:, :k]
    assert torch.equal(dist, want)
    assert torch.equal(rows.gather(1, idx.long()), want)
    assert pruned > 0 and int(comps.max()) < n


def _cell():
    return spec.Cell(spec.load_spec(), Q2).override(SMALL_INF, {"batch": 64})


def _execute(cell, trace=False):
    return main.execute(cell, seed=SEED, seconds=0.25, trace=trace, device=torch.device("cpu"),
                        t_start=time.perf_counter(), log=lambda s: None)


def test_the_cell_is_q2_and_runs_correct():
    cell = _cell()
    assert cell.config["index"]["q"] == 2.0
    result, run = _execute(cell)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"missing", "bad_answers", "dist_err", "recall_loss"}
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_traversal_that_finds_the_wrong_rows_is_not_correct_at_q2(monkeypatch):
    from repro_torch.core import search

    monkeypatch.setattr(search.InfinityIndex, "search", _wrong_rows(search.InfinityIndex.search))
    result, _ = _execute(_cell())
    checks = result["checks"]
    assert not result["correct"]
    assert checks["recall_loss"]["value"] > checks["recall_loss"]["limit"]
    assert checks["bad_answers"]["value"] == 0
    assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"]


def test_the_cells_prune_rules_drop_nothing_at_the_rerank_width(monkeypatch):
    """The rules compare with the K-th best vantage, K = 256 (the rerank's
    width), and the cell's plan scores fewer vantages than that, so no
    threshold is finite and nothing is dropped.  At K = 10 (no rerank) the
    same run drops children."""
    from repro_torch.core import vptree

    drops = []
    monkeypatch.setattr(vptree, "_prune_rules", _counting(vptree._prune_rules, drops))
    result, _ = _execute(_cell())
    assert result["correct"], result["checks"]
    assert drops and sum(drops) == 0
    drops.clear()
    _execute(_cell().override({"search": {"rerank": 0}}))
    assert sum(drops) > 0


def test_the_projection_reader_reads_the_builds_projection_stage():
    """``projection_s`` is the build's ``projection`` stage, traced or not;
    a run whose build has no such stage (the brute engine) reads None."""
    from types import SimpleNamespace

    read = spec.reader("projection_s")
    result, run = _execute(_cell(), trace=True)
    assert run.stage_seconds["projection"] > 0
    assert read(run) == run.stage_seconds["projection"]
    assert result["metrics"]["projection_s"]["value"] == read(run)
    _, untraced = _execute(_cell())
    assert read(untraced) > 0
    assert read(SimpleNamespace(stage_seconds={})) is None


@pytest.mark.gpu
def test_the_builds_logminplus_projection_matches_the_reference_on_the_card(card):
    """The cell's build at its sizes: S = 2 048 of the 60 000 rows drawn as
    ``InfinityIndex.build`` draws them, knn_k 16, 2 links, 6 hops, q = 2 on
    the qpath kernel's ``logminplus`` instance, against the reference in
    float64 on the card; TF32 off for the kNN graph and pdist in both."""
    from repro_torch.core import qmetric
    from repro_torch.kernels import _build

    cfg = spec.Cell(spec.load_spec(), Q2).config
    ds, ix = cfg["dataset"], cfg["index"]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        X = manifold(ds["train"] + ds["test"], d=ds["dim"], latent=ds["latent"],
                     num_clusters=ds["clusters"], noise=ds["noise"], seed=SEED, device=card)
        rng = np.random.default_rng(SEED)
        sub = np.sort(rng.choice(ds["train"], size=ix["proj_sample"], replace=False))
        S = X[: ds["train"]][torch.as_tensor(sub, device=card)]
        D, mask = _build_inputs(S, knn_k=ix["knn_k"], links=ix["extra_links"], rng=rng)
        before = _build.launches()["qpath/logminplus"]
        got = qmetric.sparse_canonical_projection(D, mask, ix["q"], num_hops=ix["num_hops"],
                                                  schedule="doubling")
        torch.cuda.synchronize(card)
        assert _build.launches()["qpath/logminplus"] - before == ix["num_hops"]
        ref = sparse_projection(D, mask, ix["q"], num_hops=ix["num_hops"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    _assert_projection_matches(got, ref, ix["q"])
