"""The beam's prune rules (``core/vptree.search_beam`` → ``_prune_rules``)
on the CPU, at q = 2 and q = inf.

The rules compare each node with tau, the K-th best vantage distance so
far (K the search's k).  While fewer than K vantages are scored, tau is
+inf and the rules drop nothing; so a plan that scores fewer vantages
than K, as the b512 cells' (K = 256, the rerank's width) does, never
prunes.  At a small K the same search does prune.  Telemetry on or off,
the search gives the same answers and comparisons."""
import math
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import telemetry as telem
from repro_torch.core import vptree

QS = [2.0, math.inf]


@pytest.fixture(autouse=True)
def fresh_registry():
    telem.reset()
    yield
    telem.reset()
    telem.disable()


def _beam_inputs(seed=3, n=600, d=6, b=20):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    tree = vptree.build_vptree(X, seed=seed, device="cpu")
    flat = vptree.flatten_vptree(tree, leaf_size=8, Z=X)
    Xf = torch.as_tensor(X[flat.perm.numpy()])
    return flat, torch.as_tensor(Q), Xf


def _search(flat, Q, Xf, q, k=5):
    return vptree.search_beam(flat, Q, q=q, k=k, X=Xf, max_comparisons=200, with_stages=True)


@pytest.fixture
def recorded(monkeypatch):
    """Each level's (tau, number of existing children of alive nodes that
    the rules drop), taken where ``search_beam`` calls ``_prune_rules``."""
    levels = []
    rules = vptree._prune_rules

    def spy(d, m, tau, q_inf, q):
        out, inn = rules(d, m, tau, q_inf, q)
        caller = sys._getframe(1).f_locals
        alive, nid, flat = caller["alive"], caller["nid"], caller["flat"]
        dropped = sum(int((alive & (child[nid] != -1) & drop).sum())
                      for child, drop in ((flat.child_in, inn), (flat.child_out, out)))
        levels.append((tau.clone(), dropped))
        return out, inn

    monkeypatch.setattr(vptree, "_prune_rules", spy)
    return levels


@pytest.mark.parametrize("q", QS, ids=["q2", "qinf"])
def test_the_rules_drop_nothing_while_fewer_than_k_vantages_are_scored(recorded, q):
    flat, Q, Xf = _beam_inputs()
    _, _, _, stages = _search(flat, Q, Xf, q, k=64)
    assert int(stages["traversal"].max()) < 64  # the plan scores fewer vantages than K
    assert len(recorded) == flat.depth
    for tau, dropped in recorded:
        assert torch.isinf(tau).all()
        assert dropped == 0


@pytest.mark.parametrize("q", QS, ids=["q2", "qinf"])
def test_the_rules_drop_children_once_k_vantages_are_scored(recorded, q):
    flat, Q, Xf = _beam_inputs()
    _search(flat, Q, Xf, q, k=5)
    assert len(recorded) == flat.depth
    assert any(torch.isfinite(tau).any() for tau, _ in recorded)
    assert sum(dropped for _, dropped in recorded) > 0
    # no row drops a child before its tau is finite
    assert all(dropped == 0 for tau, dropped in recorded if torch.isinf(tau).all())


@pytest.mark.parametrize("q", QS, ids=["q2", "qinf"])
def test_telemetry_on_and_off_answer_the_same(q):
    flat, Q, Xf = _beam_inputs(seed=4)
    telem.enable()
    on = _search(flat, Q, Xf, q)
    telem.disable()
    off = _search(flat, Q, Xf, q)
    for a, b in zip(on[:3], off[:3]):
        assert torch.equal(a, b)
    for stage in on[3]:
        assert torch.equal(on[3][stage], off[3][stage])
