"""Port parity: the NSW engine (``core/baselines.NSWGraph``) against the JAX
package's, on the CPU, and the registry's engine list.

A graph the port builds must hold JAX's kNN neighbours (up to near ties),
long links and entry point; a graph JAX built, loaded through
``convert.nsw_from_jax_state``, must give JAX's ids, distances and
comparison counts, filtered (the separate passing-node result buffer) and
not.  The port runs the whole batch in lockstep where JAX ``vmap``s a
``while_loop``: each query stops on its own there and here.  Tolerances:
rtol 1e-5 / atol 5e-4 (``tests/torch_parity.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import index as jindex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import chaos as tchaos  # noqa: E402
from repro_torch.core import filter as tfilter  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N = 400


@pytest.fixture(scope="module")
def data():
    pool = synthetic.make("manifold", N + 16, d=32, seed=1)
    rng = np.random.default_rng(7)
    attrs = {"score": rng.uniform(size=N).astype(np.float32),
             "tag": [f"t{i % 4}" for i in range(N)]}
    return pool[:N], pool[N:], attrs


@pytest.fixture(scope="module")
def pair(data):
    X, _, attrs = data
    jeng = jindex.build("nsw", X, {"degree": 10, "random_links": 4, "seed": 3,
                                   "attrs": attrs})
    arrays, statics = jeng.snapshot_state()
    teng = convert.nsw_from_jax_state(jax.tree_util.tree_map(np.asarray, arrays), statics,
                                      device=CPU)
    tindex.attach_store(teng, convert.attrs_from_jax_state(*jeng.attrs.snapshot_state()))
    return jeng, teng


def test_port_build_has_jax_graph(data):
    X, _, _ = data
    jeng = jindex.build("nsw", X, {"degree": 10, "random_links": 4, "seed": 3})
    teng = tindex.build("nsw", X, {"degree": 10, "random_links": 4, "seed": 3}, device=CPU)
    assert teng.entry == jeng.entry
    tn, jn = to_np(teng.neighbors), np.asarray(jeng.neighbors)
    assert tn.dtype == np.int32 and tn.shape == jn.shape == (N, 14)
    np.testing.assert_array_equal(tn[:, 10:], jn[:, 10:])  # the long links
    # kNN edges: ids equal except on near ties of their distances
    dist = lambda ids: np.linalg.norm(X[:, None] - X[ids], axis=-1)  # noqa: E731
    assert_same_ids(tn[:, :10], dist(tn[:, :10]), jn[:, :10], dist(jn[:, :10]))
    assert not (tn[:, :10] == np.arange(N)[:, None]).any()  # self excluded


@pytest.mark.parametrize("flt", [None, {"score": {"range": [None, 0.5]}},
                                 {"score": {"range": [0.0, 0.1]}},
                                 {"tag": "t2", "score": {"range": [0.3, None]}}])
@pytest.mark.parametrize("k,kw", [(1, {}), (10, {}), (10, {"ef": 48, "max_steps": 128}),
                                  (5, {"budget": 60}), (10, {"ef": 12, "max_steps": 3})])
def test_search_matches_jax(pair, data, flt, k, kw):
    _, Q, _ = data
    jeng, teng = pair
    jr = jeng.search(Q, k=k, filter=flt, **kw)
    tr = teng.search(Q, k=k, filter=flt, **kw)
    assert tr.idx.dtype == torch.int32 and tr.comparisons.dtype == torch.int32
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    if flt is not None:  # no returned id fails the filter
        mask = to_np(tfilter.resolve_mask(flt, teng.attrs, N, CPU))
        ids = to_np(tr.idx)
        assert mask[ids[ids >= 0]].all()


def test_sync_cadence_does_not_change_answers(pair, data, monkeypatch):
    """The host checks for running queries every ``NSW_SYNC_EVERY`` steps;
    a finished query is frozen, so checking at every step answers the
    same."""
    _, Q, _ = data
    _, teng = pair
    before = teng.search(Q, k=10, ef=20, max_steps=40, filter={"score": {"range": [None, 0.5]}})
    monkeypatch.setattr(tbase, "NSW_SYNC_EVERY", 1)
    after = teng.search(Q, k=10, ef=20, max_steps=40, filter={"score": {"range": [None, 0.5]}})
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_snapshot_round_trips(pair):
    jeng, teng = pair
    arrays, statics = teng.snapshot_state()
    assert statics == jeng.snapshot_state()[1]
    again = tbase.NSWGraph.from_snapshot(arrays, statics, device=CPU)
    assert torch.equal(again.neighbors, teng.neighbors) and again.entry == teng.entry
    assert teng.memory_bytes() == jeng.memory_bytes()


def test_registry_lists_the_five_engines(data):
    X, _, _ = data
    # the five engines, the live wrapper and the sharded one, as JAX's
    assert tindex.available() == ("brute", "infinity", "ivf_flat", "ivf_pq", "live",
                                  "nsw", "sharded")
    assert tindex.available() == jindex.available()
    sh = tindex.build("sharded", X, {"engine": "nsw", "shards": 2}, device=CPU)
    assert sh.shards == 2 and sh.engine == "nsw"
    eng = tindex.build("nsw", X, {"chaos": {"seed": 0, "rules": [
        {"site": "search", "start": 0, "stop": 1}]}}, device=CPU)
    with pytest.raises(tchaos.TransientFault):
        eng.search(X[:2], k=2)
