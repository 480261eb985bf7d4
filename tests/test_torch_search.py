"""Port parity for the whole slice: ``InfinityIndex`` build and search.

A JAX-built index (``configs/infinity_search.py:REDUCED``) is loaded through
``convert.index_from_jax_state``; every search mode must return JAX's ids
and comparison counts.  The deterministic build stages (subset S, kNN ids,
the projection Dq) are replayed through both packages.  A port-trained
index at the ``bench_infinity`` config must reach the committed beam recall
(``experiments/BENCH_infinity.json``: 0.939 at q=inf) within 0.03 — on the
CPU, with the kernels' plain versions."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.infinity_search import REDUCED  # noqa: E402
from repro.core import knn_graph as jknn  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import qmetric as jq  # noqa: E402
from repro.core.search import InfinityIndex as JaxIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as index_lib  # noqa: E402
from repro_torch.core import knn_graph as tknn  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import qmetric as tq  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.core.search import IndexConfig, InfinityIndex  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    X = synthetic.make("clustered", 680, d=16, num_clusters=6, seed=0)
    return X[:600], X[600:]


@pytest.fixture(scope="module")
def pair(data):
    """(JAX index, the port index loaded from its state)."""
    X, _ = data
    jidx = JaxIndex.build(jnp.asarray(X), REDUCED)
    arrays, statics = jidx.snapshot_state()
    arrays = jax.tree_util.tree_map(np.asarray, arrays)
    return jidx, convert.index_from_jax_state(arrays, statics, device=CPU)


def test_loaded_state_is_the_jax_state(pair):
    jidx, tidx = pair
    np.testing.assert_array_equal(to_np(tidx.X), np.asarray(jidx.X))
    np.testing.assert_array_equal(to_np(tidx.tree.vantage), np.asarray(jidx.tree.vantage))
    assert tidx.config == IndexConfig(**{**REDUCED.__dict__})
    Zt = tidx.phi(tidx.X).detach()
    np.testing.assert_allclose(to_np(Zt), np.asarray(jidx.Z), atol=1e-5)


@pytest.mark.parametrize("mode,k,kw", [
    ("descend", 1, {}),
    ("best_first", 5, {"budget": 150}),
    ("best_first", 5, {"budget": 300, "rerank": 32}),
    ("beam", 5, {"budget": 300, "rerank": 64}),
    ("beam", 10, {}),
    ("auto", 1, {}),
    ("auto", 5, {"rerank": 32, "budget": 250}),
])
def test_search_modes_match_jax(pair, data, mode, k, kw):
    jidx, tidx = pair
    _, Q = data
    jr = jidx.search(jnp.asarray(Q), k=k, mode=mode, **kw)
    tr = tidx.search(Q, k=k, mode=mode, **kw)
    assert tr.idx.dtype == torch.int32 and tr.comparisons.dtype == torch.int32
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))


def test_auto_mode_routes_like_jax(pair, data):
    _, tidx = pair
    _, Q = data
    big = tidx.search(Q, k=5, rerank=32, budget=250)
    beam = tidx.search(Q, k=5, rerank=32, budget=250, mode="beam")
    assert torch.equal(big.idx, beam.idx)
    small = tidx.search(Q[:10], k=5, rerank=32, budget=250)
    bf = tidx.search(Q[:10], k=5, rerank=32, budget=250, mode="best_first")
    assert torch.equal(small.idx, bf.idx)
    one = tidx.search(Q[:10], k=1)
    desc = tidx.search(Q[:10], k=1, mode="descend")
    assert torch.equal(one.comparisons, desc.comparisons)


def test_deterministic_build_stages_match_jax(data):
    """S, the kNN ids and the projection Dq, replayed with each package's
    functions under the build's seeding."""
    X, _ = data
    cfg = REDUCED
    rng = np.random.default_rng(cfg.seed)
    sub = np.sort(rng.choice(X.shape[0], size=cfg.proj_sample, replace=False))
    links = rng.integers(0, cfg.proj_sample, size=(cfg.proj_sample, cfg.extra_links))
    S = X[sub]
    ji, jd = jknn.knn_graph(jnp.asarray(S), k=cfg.knn_k)
    ti, td = tknn.knn_graph(torch.as_tensor(S), k=cfg.knn_k)
    assert_same_ids(ti, td, ji, jd)
    jmask = jknn.knn_mask(ji, len(S)) | jknn.knn_mask(jnp.asarray(links, jnp.int32), len(S))
    tmask = tknn.knn_mask(ti, len(S)) | tknn.knn_mask(torch.as_tensor(links), len(S))
    np.testing.assert_array_equal(to_np(tmask), np.asarray(jmask))
    JD = jnp.where(jnp.eye(len(S), dtype=bool), 0.0, jmetrics.pairwise(jnp.asarray(S), jnp.asarray(S)))
    TD = tmetrics.pairwise(torch.as_tensor(S), torch.as_tensor(S))
    TD = torch.where(torch.eye(len(S), dtype=torch.bool), 0.0, TD)
    for q in (2.0, math.inf):
        jdq = jq.sparse_canonical_projection(JD, jmask, q, num_hops=cfg.num_hops,
                                             schedule="doubling")
        tdq = tq.sparse_canonical_projection(TD, tmask, q, num_hops=cfg.num_hops,
                                             schedule="doubling")
        r, o = np.asarray(jdq), to_np(tdq)
        assert np.array_equal(np.isinf(r), np.isinf(o))
        np.testing.assert_allclose(o[np.isfinite(r)], r[np.isfinite(r)], rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("q,target", [(2.0, 0.999), (math.inf, 0.939)])
def test_port_build_reaches_bench_recall(q, target):
    """The bench_infinity config (manifold n=2048, 512 queries, budget 1024,
    rerank 256, proj_sample 512, 300 steps): beam recall@10 within 0.03 of
    the committed figure."""
    pool = synthetic.make("manifold", 2048 + 512, seed=0)
    X, Q = pool[:2048], pool[2048:]
    idx = index_lib.build("infinity", X, {
        "q": q, "proj_sample": 512, "train_steps": 300,
        "budget": 1024, "rerank": 256,
    }, device=CPU)
    res = idx.search(Q, k=10)
    _, gt = tscan.topk_scan(torch.as_tensor(Q), idx.X, k=10)
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(to_np(res.idx), to_np(gt))])
    print(f"bench config q={q} beam recall@10 {rec:.4f} (target {target}); "
          f"nn_overlap10 {idx.train_history['validation']['nn_overlap10']:.4f}")
    assert abs(rec - target) <= 0.03
    assert set(idx.train_history["stage_seconds"]) == {
        "subset", "knn_graph", "pdist", "projection", "train_phi", "embed", "vptree"}


def test_fashion_like_recall_tracks_jax():
    """On ``fashion_like`` (the full-width smoke's data) the port's beam
    recall at q=inf tracks the JAX package's within 0.05.  Both fit Phi
    with their own random streams, so this is statistical parity; at this
    size (n=4000, proj_sample 512, 300 steps) the two agree within 0.02.
    ``tests/torch_recall_ladder.py`` runs the same comparison at larger n."""
    pool = synthetic.fashion_like(4000 + 256, seed=0)
    X, Q = pool[:4000], pool[4000:]
    _, gt = tscan.topk_scan(torch.as_tensor(Q), torch.as_tensor(X), k=10)
    kw = dict(q=math.inf, proj_sample=512, train_steps=300)
    jidx = JaxIndex.build(jnp.asarray(X), REDUCED.__class__(**kw))
    tidx = InfinityIndex.build(X, IndexConfig(**kw), device=CPU)
    search = dict(k=10, budget=1024, rerank=256, mode="beam")
    recalls = []
    for ids in (jidx.search(jnp.asarray(Q), **search).idx, tidx.search(Q, **search).idx):
        recalls.append(np.mean([len(set(a) & set(b)) / 10
                                for a, b in zip(to_np(ids), to_np(gt))]))
    print(f"fashion_like n=4000 q=inf beam recall@10: jax {recalls[0]:.4f} "
          f"port {recalls[1]:.4f}; nn_overlap10 jax "
          f"{jidx.train_history['validation']['nn_overlap10']:.4f} port "
          f"{tidx.train_history['validation']['nn_overlap10']:.4f}")
    assert abs(recalls[0] - recalls[1]) <= 0.05


@pytest.fixture(scope="module")
def manhattan_pair(data):
    """A JAX-built manhattan index and the port index loaded from it."""
    import dataclasses

    X, _ = data
    jidx = JaxIndex.build(jnp.asarray(X), dataclasses.replace(
        REDUCED, metric="manhattan", train_steps=60))
    arrays, statics = jidx.snapshot_state()
    arrays = jax.tree_util.tree_map(np.asarray, arrays)
    return jidx, convert.index_from_jax_state(arrays, statics, device=CPU)


@pytest.mark.parametrize("mode,k,kw", [
    ("descend", 1, {}),
    ("best_first", 5, {"budget": 300, "rerank": 32}),
    ("beam", 10, {"budget": 300, "rerank": 64}),
])
def test_manhattan_index_matches_jax(manhattan_pair, data, mode, k, kw):
    """All three modes on a manhattan index: the tree is searched in the
    embedding, the rerank scores candidates in manhattan."""
    jidx, tidx = manhattan_pair
    _, Q = data
    assert tidx.config.metric == "manhattan"
    jr = jidx.search(jnp.asarray(Q), k=k, mode=mode, **kw)
    tr = tidx.search(Q, k=k, mode=mode, **kw)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))


def test_manhattan_build_stages_match_jax(data):
    """The kNN ids and D of a manhattan build's subset (the cube regimes of
    the topk and pdist kernels, here their plain versions) against JAX."""
    X, _ = data
    S = X[:256]
    ji, jd = jknn.knn_graph(jnp.asarray(S), k=8, metric="manhattan")
    ti, td = tknn.knn_graph(torch.as_tensor(S), k=8, metric="manhattan")
    assert_same_ids(ti, td, ji, jd)
    JD = jmetrics.pairwise(jnp.asarray(S), jnp.asarray(S), metric="manhattan")
    TD = tmetrics.pairwise(torch.as_tensor(S), torch.as_tensor(S), metric="manhattan")
    np.testing.assert_allclose(to_np(TD), np.asarray(JD), rtol=1e-5, atol=5e-4)


def test_refresh_reembeds_without_training(pair, data):
    _, tidx = pair
    X, Q = data
    new = tidx.refresh(X[:300])
    assert new.phi is tidx.phi and new.X.shape == (300, X.shape[1])
    np.testing.assert_allclose(to_np(new.Z), to_np(tidx.phi(new.X).detach()), atol=1e-6)
    res = new.search(Q, k=3, rerank=16)
    assert (res.idx >= 0).all() and (res.idx < 300).all()


def test_registry_build_defaults_and_reserved_keys(data):
    X, Q = data
    small = {"proj_sample": 64, "knn_k": 4, "num_hops": 2, "embed_dim": 4,
             "hidden": (8,), "train_steps": 5, "batch_pairs": 32}
    idx = index_lib.build("infinity", X[:120], small | {"rerank": 8, "budget": 50},
                          device=CPU)
    assert idx.search_defaults == {"rerank": 8, "budget": 50}
    assert index_lib.available() == ("brute", "infinity", "ivf_flat", "ivf_pq", "live",
                                     "nsw", "sharded")
    with pytest.raises(TypeError, match="chaos cfg must be"):
        index_lib.build("infinity", X[:120], small | {"chaos": True}, device=CPU)
    tagged = index_lib.build("infinity", X[:120], small | {"attrs": {"tag": np.arange(120)}},
                             device=CPU)
    assert tagged.attrs.n == 120
    assert (tagged.search(Q, k=3, filter={"tag": {"range": [None, 59]}}).idx < 60).all()
    assert index_lib.build("infinity", X[:120], small | {"quant": True},
                           device=CPU).quant.rows == 120
    with pytest.raises(TypeError, match="unknown cfg keys"):
        index_lib.build("infinity", X[:120], {"nprobe": 3}, device=CPU)


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch, data):
    X, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InfinityIndex.build(X[:100], IndexConfig(proj_sample=32, train_steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        index_lib.build("infinity", X[:100], {})
    assert resolve_device("cpu") == torch.device("cpu")
