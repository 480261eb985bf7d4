"""``correct`` comes out false when the timed path is broken underneath.

Each test drives a whole run (set-up, window, reference, verdict) at a
size the CPU holds, skipping only the harness's look for a card, with one
fault planted in the program: an answer altered where it is produced,
half of a batch left out, a state left unchanged (the deletes never
applied), stale answers (the previous batch's), a traversal that finds
the wrong rows and scores them exactly.  The control (the reference in
TF32 in the program's place) fails too.  Cells on one chip have no
exchange between chips to leave out."""
import time

import numpy as np
import pytest
import torch

from bench import control
from bench.harness import main, spec

SMALL_INF = {"dataset": {"train": 1200, "test": 160},
             "index": {"train_steps": 20, "proj_sample": 128, "batch_pairs": 64,
                       "val_pairs": 64, "hidden": [32, 32], "embed_dim": 8}}
SMALL_LIVE = {"dataset": {"train": 1200, "test": 160}, "server": {"delta_cap": 60}}
INF = "fmnist784-infinity-b512"
LIVE = "fmnist784-live-fresh5pct"


def _cell(name):
    c = spec.Cell(spec.load_spec(), name)
    cfg = SMALL_LIVE if c.config["server"].get("live") else SMALL_INF
    tr = {"batch": 64}
    if "delete_frozen" in c.traffic:
        tr["delete_frozen"] = 60  # 5 %, re-inserted into a delta of 60
    return c.override(cfg, tr)


def _execute(cell, device=torch.device("cpu"), seconds=0.25, trace=False):
    result, run = main.execute(cell, seed=2**31 + 17, seconds=seconds, trace=trace,
                               device=device, t_start=time.perf_counter(), log=lambda s: None)
    return result, run


@pytest.fixture
def query_fault(monkeypatch):
    """Plant ``fault(result, batch) -> result`` under ``SearchServer.query``."""
    from repro_torch.launch import serve

    def plant(fault):
        orig = serve.SearchServer.query

        def broken(self, batch, *a, **kw):
            return fault(orig(self, batch, *a, **kw), batch)

        monkeypatch.setattr(serve.SearchServer, "query", broken)

    return plant


@pytest.mark.parametrize("name", [INF, LIVE])
def test_the_sound_program_is_correct(name):
    result, run = _execute(_cell(name))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


def _altered(res, batch):
    idx = res.idx.copy()
    idx[:, 0] = (idx[:, 0] + 1) % 1200  # another row, its distance kept
    return res._replace(idx=idx)


def _half(res, batch):
    h = max(1, len(res.idx) // 2)
    return res._replace(idx=res.idx[:h], dist=res.dist[:h], comparisons=res.comparisons[:h])


class _Stale:
    def __init__(self):
        self.last = None

    def __call__(self, res, batch):
        prev, self.last = self.last, res
        return res if prev is None or len(prev.idx) != len(res.idx) else prev


@pytest.mark.parametrize("fault", [_altered, _half, _Stale()], ids=["altered", "half", "stale"])
@pytest.mark.parametrize("name", [INF, LIVE])
def test_a_broken_answer_is_not_correct(query_fault, fault, name):
    query_fault(fault)
    result, _ = _execute(_cell(name))
    assert not result["correct"], result["checks"]


def test_deletes_left_unapplied_are_not_correct(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(serve.SearchServer, "delete", lambda self, ids: 0)
    result, _ = _execute(_cell(LIVE))
    assert not result["correct"]
    assert result["checks"]["bad_answers"]["value"] > 0


def test_reinserts_left_out_are_not_correct(monkeypatch):
    """The deletes applied, the cycle's re-inserts never made: answers miss
    the alive rows of the delta."""
    from repro_torch.launch import serve

    monkeypatch.setattr(serve.SearchServer, "upsert", lambda self, vectors, **kw: None)
    result, _ = _execute(_cell(LIVE))
    assert not result["correct"]
    assert result["checks"]["rank_gap"]["value"] > result["checks"]["rank_gap"]["limit"]


def _wrong_rows(orig):
    """The traversal finds other rows than it should (drawn at random) and
    the rerank scores them exactly: ids alive and unique, distances exact
    and ascending."""

    def search(self, Q, k=1, **kw):
        res = orig(self, Q, k=k, **kw)
        gen = torch.Generator().manual_seed(7)
        n = self.X.shape[0]
        B = res.idx.shape[0]
        ids = torch.stack([torch.randperm(n, generator=gen)[:k] for _ in range(B)])
        ids = ids.to(self.X.device)
        Qd = torch.as_tensor(Q, device=self.X.device).double()
        dist = torch.linalg.vector_norm(Qd[:, None, :] - self.X[ids].double(), dim=-1)
        dist, order = torch.sort(dist, dim=1)
        ids = torch.gather(ids, 1, order)
        return res._replace(idx=ids.to(res.idx.dtype), dist=dist.to(res.dist.dtype))

    return search


def test_a_traversal_that_finds_the_wrong_rows_is_not_correct(monkeypatch):
    from repro_torch.core import search

    monkeypatch.setattr(search.InfinityIndex, "search", _wrong_rows(search.InfinityIndex.search))
    result, _ = _execute(_cell(INF))
    checks = result["checks"]
    assert not result["correct"]
    # every other number passes: only the recall sees it
    assert checks["recall_loss"]["value"] > checks["recall_loss"]["limit"]
    assert checks["bad_answers"]["value"] == 0
    assert checks["dist_err"]["value"] <= checks["dist_err"]["limit"]


@pytest.mark.parametrize("name", [INF, LIVE])
def test_the_control_is_not_correct(name):
    reading = control.readings(_cell(name).override(
        {"dataset": {"train": 4000, "test": 200}}), 2**31 + 23, torch.device("cpu"))
    assert not reading["correct"]
    assert reading["checks"]["dist_err"]["value"] > reading["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("name, numbers", [
    (INF, {"missing", "bad_answers", "dist_err", "recall_loss"}),
    (LIVE, {"missing", "bad_answers", "dist_err", "rank_gap"})])
def test_every_number_is_checked_beside_its_limit(name, numbers):
    result, _ = _execute(_cell(name))
    assert set(result["checks"]) == numbers
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    assert np.isfinite(result["checks"]["dist_err"]["value"])


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card(card):
    """The harness end to end on the card at a small size, traced."""
    result, run = _execute(_cell(LIVE), device=card, seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0 and "breakdown" in result
