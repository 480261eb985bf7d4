"""Port parity: k-means and the IVF engines (``IVFFlat``, ``IVFPQ``) of
``core/baselines`` against the JAX package's (its default ``impl="jnp"``
path), on the CPU.

JAX draws k-means' initial centroids from ``PRNGKey(seed)``, which torch
cannot reproduce, so ``_lloyd`` is handed JAX's draw.  The engines are
built by JAX and loaded into the port through ``convert``; every search,
filtered or not, f32 or through the ``quant`` view, must return JAX's ids
and comparison counts.  Tolerances: rtol 1e-5 / atol 5e-4
(``tests/torch_parity.py``), ids equal except on near ties."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from torch_parity import assert_close, assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N, D = 480, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(12, D)).astype(np.float32) * 3
    X = (centers[rng.integers(0, 12, size=N)]
         + rng.normal(size=(N, D)).astype(np.float32))
    Q = X[rng.choice(N, 12, replace=False)] + 0.3 * rng.normal(size=(12, D)).astype(np.float32)
    attrs = {"score": rng.uniform(size=N).astype(np.float32),
             "shop": [f"s{i % 5}" for i in range(N)]}
    return X.astype(np.float32), Q.astype(np.float32), attrs


def _state(jeng):
    arrays, statics = jeng.snapshot_state()
    return jax.tree_util.tree_map(np.asarray, arrays), statics


def _with_attrs(teng, jeng):
    """Carry JAX's attribute store and quant store (when it has them) to the
    port engine."""
    if getattr(jeng, "attrs", None) is not None:
        tindex.attach_store(teng, convert.attrs_from_jax_state(*jeng.attrs.snapshot_state()))
    if getattr(jeng, "quant", None) is not None:
        tindex.attach_quant_store(teng, convert.quant_store_from_jax(
            jeng.quant.snapshot_state()[0], device=CPU))
    return teng


FILTERS = [None, {"score": {"range": [None, 0.3]}},
           {"shop": ["s1", "s3"], "score": {"range": [0.2, 0.9]}}]


@pytest.mark.parametrize("C,iters,metric", [(8, 5, "sqeuclidean"), (16, 10, "sqeuclidean"),
                                            (7, 4, "euclidean")])
def test_lloyd_matches_jax_kmeans(data, C, iters, metric):
    X, _, _ = data
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(4), N, (C,), replace=False))
    jc, ja = jbase.kmeans(jnp.asarray(X), num_clusters=C, iters=iters, metric=metric, seed=4)
    tc, ta = tbase._lloyd(torch.as_tensor(X), torch.as_tensor(X[init]), iters, metric)
    assert_close(tc, jc)
    np.testing.assert_array_equal(to_np(ta), np.asarray(ja))


def test_kmeans_draw_and_lists(data):
    X, _, _ = data
    cents, assign = tbase.kmeans(torch.as_tensor(X), num_clusters=8, seed=2)
    again, _ = tbase.kmeans(torch.as_tensor(X), num_clusters=8, seed=2)
    assert torch.equal(cents, again)  # the draw is a function of the seed
    lists, lens = tbase._build_lists(to_np(assign), 8)
    jl, jlens = jbase._build_lists(to_np(assign), 8)
    np.testing.assert_array_equal(lists, jl)
    np.testing.assert_array_equal(lens, jlens)
    assert lens.sum() == N and lists.shape[1] == lens.max()


@pytest.mark.parametrize("nprobe,budget,C", [(None, None, 8), (3, 999, 8), (None, 130, 8),
                                             (None, 5, 8), (99, None, 8), (None, 10 ** 6, 48),
                                             (0, None, 4)])
def test_probe_policy_matches_jax(nprobe, budget, C):
    assert tbase._resolve_nprobe(nprobe, budget, n=N, num_clusters=C) == \
        jbase._resolve_nprobe(nprobe, budget, n=N, num_clusters=C)


@pytest.fixture(scope="module")
def ivf_flat(data):
    X, _, attrs = data
    jeng = jindex.build("ivf_flat", X, {"num_clusters": 12, "nprobe": 3, "attrs": attrs})
    jq = jindex.build("ivf_flat", X, {"num_clusters": 12, "nprobe": 3, "attrs": attrs,
                                      "quant": True})
    return [(j, _with_attrs(convert.ivf_flat_from_jax_state(*_state(j), device=CPU), j))
            for j in (jeng, jq)]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quant"])
@pytest.mark.parametrize("flt", range(len(FILTERS)))
@pytest.mark.parametrize("k", [1, 10])
def test_ivf_flat_matches_jax(ivf_flat, data, quant, flt, k):
    _, Q, _ = data
    jeng, teng = ivf_flat[quant]
    jr = jeng.search(Q, k=k, filter=FILTERS[flt])
    tr = teng.search(Q, k=k, filter=FILTERS[flt])
    assert tr.idx.dtype == torch.int32 and tr.comparisons.dtype == torch.int32
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))


def test_ivf_flat_state_round_trips(ivf_flat):
    jeng, teng = ivf_flat[0]
    arrays, statics = teng.snapshot_state()
    assert statics == jeng.snapshot_state()[1]
    again = tbase.IVFFlat.from_snapshot(arrays, statics, device=CPU)
    for key in ("X", "centroids", "lists", "list_lens"):
        assert torch.equal(getattr(again, key), getattr(teng, key))
    assert teng.memory_bytes() == jeng.memory_bytes()


@pytest.fixture(scope="module")
def ivf_pq(data):
    X, _, attrs = data
    jeng = jindex.build("ivf_pq", X, {"num_clusters": 10, "M": 6, "ksub": 16, "nprobe": 3,
                                      "attrs": attrs})
    return jeng, _with_attrs(convert.ivf_pq_from_jax_state(*_state(jeng), device=CPU), jeng)


@pytest.mark.parametrize("rerank", [0, 24])
@pytest.mark.parametrize("flt", range(len(FILTERS)))
def test_ivf_pq_matches_jax(ivf_pq, data, rerank, flt):
    _, Q, _ = data
    jeng, teng = ivf_pq
    jr = jeng.search(Q, k=8, rerank=rerank, filter=FILTERS[flt])
    tr = teng.search(Q, k=8, rerank=rerank, filter=FILTERS[flt])
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    assert teng.memory_bytes() == jeng.memory_bytes()


@pytest.mark.parametrize("engine,cfg", [
    ("ivf_flat", {"num_clusters": 8, "nprobe": 8}),
    ("ivf_pq", {"num_clusters": 8, "M": 4, "ksub": 16, "nprobe": 8, "rerank": 64}),
])
def test_port_built_ivf_probing_every_list_is_exact(data, engine, cfg):
    """Probing every list (and, for IVF-PQ, reranking a wide ADC shortlist)
    finds the exact neighbours of the passing rows; no failing id leaks."""
    X, Q, attrs = data
    teng = tindex.build(engine, X, cfg | {"attrs": attrs}, device=CPU)
    flt = {"score": {"range": [None, 0.5]}}
    mask = attrs["score"] <= 0.5
    gt = tindex.build("brute", X[mask], {}, device=CPU).search(Q, k=5)
    tr = teng.search(Q, k=5, filter=flt)
    ids = to_np(tr.idx)
    assert mask[ids].all()
    rec = np.mean([len(set(a) & set(np.where(mask)[0][b])) / 5
                   for a, b in zip(ids, to_np(gt.idx))])
    assert rec >= (1.0 if engine == "ivf_flat" else 0.9)


@pytest.mark.parametrize("rows", [1, 5])
def test_chunked_candidate_gather_matches_one_chunk(data, monkeypatch, rows):
    """``scan.in_chunks`` splits the (B, C, d) gather over queries; the
    answers are those of one chunk."""
    X, Q, _ = data
    rng = np.random.default_rng(0)
    cand = torch.as_tensor(rng.integers(-1, N, size=(Q.shape[0], 100)), dtype=torch.int32)
    Xt, Qt = torch.as_tensor(X), torch.as_tensor(Q)
    whole = tscan.topk_candidates(Qt, cand, Xt, k=7, metric="euclidean")
    monkeypatch.setattr(tscan, "GATHER_BYTES", rows * 4 * 100 * D)
    parts = tscan.topk_candidates(Qt, cand, Xt, k=7, metric="euclidean")
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
