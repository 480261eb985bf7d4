"""Port parity: ``core/live`` — mutation over a live index restored from a
JAX live snapshot, on the CPU.

Both packages load the same JAX snapshot (taken mid-churn: the delta,
its embeddings and the tombstones are in it) and run the same upsert /
delete / compact / search script.  After every step: the same ids from
search (near ties aside; distances rtol 1e-5 / atol 5e-4), the same ids
from upsert, the same remap from ``compact()``, the same
``slot_to_logical()`` and the same ``stats()``.  Deleted rows are never
returned, and an upserted row is its own nearest neighbour on the next
query.  Cases: brute with full compaction (and auto-compaction mid-batch),
infinity with refresh compaction, without and with a quant store, and a
filtered brute.  The port's snapshot of the final state loads in JAX.

With a quant store the delta's int8 first pass in the port is the int8
kernel's function (JAX's ``impl="pallas"``) where JAX's live index runs
its jnp scan; the delta capacity is kept at the shortlist width, so the
exact f32 rerank sees every alive delta row in both and the answers are
exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import index as jindex  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import live as tlive  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N, D, K = 200, 16, 5
INF_CFG = {"q": 8.0, "proj_sample": 120, "knn_k": 8, "num_hops": 4, "embed_dim": 8,
           "hidden": (32,), "train_steps": 60, "batch_pairs": 128, "rerank": 16}
CASES = {
    "brute full": ({"engine": "brute", "engine_cfg": {}, "delta_cap": 48,
                    "auto_compact": False}, "full"),
    "brute auto-compact": ({"engine": "brute", "engine_cfg": {}, "delta_cap": 16,
                            "compact_deleted_frac": 0.05}, "full"),
    "infinity refresh": ({"engine": "infinity", "engine_cfg": INF_CFG, "delta_cap": 48,
                          "auto_compact": False, "compact_mode": "refresh"}, "refresh"),
    "infinity refresh quant": ({"engine": "infinity", "engine_cfg": INF_CFG,
                                "delta_cap": 32, "auto_compact": False,
                                "compact_mode": "refresh", "quant": True}, "refresh"),
    "brute filtered": ({"engine": "brute", "engine_cfg": {}, "delta_cap": 48,
                        "auto_compact": False}, "full"),
}
FILTER = {"score": {"range": [None, 0.6]}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Xnew = rng.normal(size=(80, D)).astype(np.float32)
    Q = rng.normal(size=(10, D)).astype(np.float32)
    score = rng.uniform(size=N + 80).astype(np.float32)
    return X, Xnew, Q, score


def _pair(case, data, tmp_path):
    """(JAX live, port live), both loaded from one JAX snapshot taken after
    a first churn burst, plus the script's filter."""
    X, Xnew, _, score = data
    cfg, _ = CASES[case]
    cfg = dict(cfg)
    filtered = case.endswith("filtered")
    if filtered:
        cfg["attrs"] = {"score": score[:N]}
    live = jindex.build("live", X, cfg)
    ids = live.upsert(Xnew[:6], attrs={"score": score[N:N + 6]} if filtered else None)
    live.delete([1, int(ids[2])])
    path = jstore.save(live, str(tmp_path / "jax_live"))
    return jstore.load(path), tstore.load(path, device=CPU), (FILTER if filtered else None)


def _check_state(j, t, what):
    np.testing.assert_array_equal(t.slot_to_logical(), j.slot_to_logical(), err_msg=what)
    assert t.stats() == j.stats(), what
    np.testing.assert_array_equal(t.corpus(), j.corpus(), err_msg=what)


def _check_search(j, t, Q, flt, what):
    for f in (None, flt) if flt is not None else (None,):
        jr, tr = j.search(Q, k=K, filter=f), t.search(Q, k=K, filter=f)
        assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
        np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons),
                                      err_msg=what)
        # no tombstoned slot is ever returned
        s2l = t.slot_to_logical()
        got = to_np(tr.idx)
        assert ((got == -1) | (s2l[np.clip(got, 0, len(s2l) - 1)] >= 0)).all(), what


def _check_own_neighbours(t, rows, ids, what):
    res = t.search(rows, k=1)
    np.testing.assert_array_equal(to_np(res.idx)[:, 0], ids, err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_mutation_script_matches_jax(case, data, tmp_path):
    X, Xnew, Q, score = data
    _, mode = CASES[case]
    j, t, flt = _pair(case, data, tmp_path)
    attrs = (lambda lo, hi: {"score": score[N + lo:N + hi]}) if flt else (lambda lo, hi: None)
    _check_state(j, t, "restored")
    _check_search(j, t, Q, flt, "restored")

    steps = [
        ("upsert", 6, 31, None),
        ("delete", [3, 17, 42], None, None),
        ("upsert", 31, 40, "replace"),
        ("compact", None, None, None),
        ("upsert", 40, 70, None),
        ("delete", "fresh", None, None),
    ]
    fresh = None
    for i, (op, a, b, how) in enumerate(steps):
        what = f"step {i}: {op}"
        if op == "upsert":
            ids_arg = None
            if how == "replace":  # two replacements, the rest plain inserts
                ids_arg = np.full(b - a, -1, np.int64)
                ids_arg[:2] = [5, int(fresh[3])]
            jid = j.upsert(Xnew[a:b], ids=ids_arg, attrs=attrs(a, b))
            tid = t.upsert(Xnew[a:b], ids=ids_arg, attrs=attrs(a, b))
            np.testing.assert_array_equal(tid, jid, err_msg=what)
            fresh = tid
            _check_own_neighbours(t, Xnew[a:b], tid, what)
        elif op == "delete":
            ids = fresh[[0, 4]] if a == "fresh" else a
            assert t.delete(ids) == j.delete(ids)
        else:
            np.testing.assert_array_equal(t.compact(mode), j.compact(mode), err_msg=what)
        _check_state(j, t, what)
        _check_search(j, t, Q, flt, what)

    back = jstore.load(tstore.save(t, str(tmp_path / "port_live")))
    _check_state(j, back, "port snapshot in JAX")
    jr, br = j.search(Q, k=K), back.search(Q, k=K)
    np.testing.assert_array_equal(np.asarray(br.idx), np.asarray(jr.idx))


def test_upsert_delete_semantics_match_jax(data):
    """JAX's ``test_upsert_delete_semantics``: replace-by-id tombstones the
    old slot, unknown ids raise, deletes never renumber."""
    X, Xnew, Q, _ = data
    cfg = {"engine": "brute", "delta_cap": 8, "auto_compact": False}
    j, t = jindex.build("live", X, dict(cfg)), tindex.build("live", X, dict(cfg), device=CPU)
    for live in (j, t):
        ids = live.upsert(Xnew[:3])
        np.testing.assert_array_equal(ids, [N, N + 1, N + 2])
        new = live.upsert(Xnew[3:4], ids=[int(ids[1])])
        assert new.tolist() == [N + 3]
        assert live.stats()["tombstones"] == 1
        with pytest.raises(KeyError, match="out of range"):
            live.delete([N + 50])
        assert live.delete([0, 0, 1]) == 2 and live.delete([0]) == 0
        with pytest.raises(ValueError, match="dim"):
            live.upsert(np.ones((1, D + 1), np.float32))
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(t.slot_to_logical(), j.slot_to_logical())


def test_clean_generation_is_the_frozen_engine(data):
    """With nothing upserted or deleted, the live wrapper answers exactly
    as its frozen engine (and launches no delta scan)."""
    X, _, Q, _ = data
    live = tindex.build("live", X, {"engine": "brute"}, device=CPU)
    frozen = tindex.build("brute", X, {}, device=CPU)
    a, b = live.search(Q, k=K), frozen.search(Q, k=K)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.dist, b.dist)


def test_live_rejects_bad_config_as_jax(data):
    X = data[0]
    for bad, err in (({"engine": "live"}, TypeError), ({"delta_cap": 0}, ValueError),
                     ({"compact_mode": "fast"}, ValueError),
                     ({"engine_cfg": {}, "metric": "cosine"}, TypeError)):
        with pytest.raises(err) as je:
            jindex.build("live", X, dict(bad))
        with pytest.raises(err) as te:
            tindex.build("live", X, dict(bad), device=CPU)
        assert str(te.value) == str(je.value)
    # over sharded (tests/test_torch_sharded.py holds it to JAX's answers)
    over = tindex.build("live", X, {"engine": "sharded", "delta_cap": 4}, device=CPU)
    assert over.stats()["frozen_size"] == X.shape[0]
    assert isinstance(tindex.build("live", X, {}, device=CPU), tlive.LiveIndex)
