"""Port parity: attribute filters — ``core/attrs`` and ``core/filter`` — and
filtered search on the brute and infinity engines, against the JAX package
(its default ``impl="jnp"`` path; the quantized brute against its Pallas
int8 kernel in interpret mode, whose function the port computes), on the
CPU.

The same numpy columns build both packages' stores; masks must be equal
bit for bit, errors must carry JAX's types and messages, and the
selectivity arithmetic must give JAX's numbers.  Filtered brute must equal
JAX's and a brute scan over the passing sub-corpus; filtered infinity on a
JAX-built index (``convert.index_from_jax_state``) must return JAX's ids
and comparison counts, beam and best-first, and no failing id.
Tolerances: rtol 1e-5 / atol 5e-4 (``tests/torch_parity.py``), ids equal
except on near ties."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.infinity_search import REDUCED  # noqa: E402
from repro.core import attrs as jattrs  # noqa: E402
from repro.core import filter as jfilter  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core.search import InfinityIndex as JaxIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import attrs as tattrs  # noqa: E402
from repro_torch.core import filter as tfilter  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N = 384


def _values(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    price = rng.uniform(size=n).astype(np.float32)
    price[rng.choice(n, n // 10, replace=False)] = np.nan  # missing numerics
    shop = [f"s{i % 6}" for i in range(n)]
    for i in rng.choice(n, n // 12, replace=False):
        shop[i] = None  # missing labels
    return {"price": price, "count": rng.integers(0, 8, size=n), "shop": shop}


@pytest.fixture(scope="module")
def stores():
    vals = _values(N)
    return vals, jattrs.AttributeStore.build(vals, N), tattrs.AttributeStore.build(vals, N)


SPECS = [
    {"price": {"range": [None, 0.5]}},
    {"price": {"range": [0.2, None]}},
    {"price": {"range": [0.2, 0.7]}},
    {"price": {"eq": None}},
    {"price": [0.1, None, 2]},
    {"count": {"range": [2, 4]}},
    {"count": 3},
    {"count": {"isin": [0, 7]}},
    {"shop": "s2"},
    {"shop": ["s1", "zzz"]},
    {"shop": "zzz"},
    {"shop": {"eq": None}},
    {"shop": {"isin": ["s0", "s5"]}, "price": {"range": [0.1, 0.9]}, "count": [1, 2, 3]},
]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_compile_mask_matches_jax(stores, spec):
    _, js, ts = stores
    jm = np.asarray(jfilter.compile_mask(jfilter.Filter.from_spec(spec), js))
    tm = tfilter.compile_mask(tfilter.Filter.from_spec(spec), ts, CPU)
    assert tm.dtype == torch.bool
    np.testing.assert_array_equal(to_np(tm), jm)


def test_equality_on_a_stored_value_and_clause_forms(stores):
    vals, js, ts = stores
    v = float(vals["price"][5])
    for spec in ({"price": v}, [tfilter.Clause("price", "eq", v)]):
        jspec = spec if isinstance(spec, dict) else [jfilter.Clause("price", "eq", v)]
        tm = tfilter.compile_mask(tfilter.Filter.from_spec(spec), ts, CPU)
        np.testing.assert_array_equal(
            to_np(tm), np.asarray(jfilter.compile_mask(jfilter.Filter.from_spec(jspec), js)))
        assert bool(tm[5])


BAD_SPECS = [[], {}, "price", 3, {"price": {"range": [None, None]}},
             {"price": {"lt": 3}}, {"price": {"eq": 1, "isin": [1]}}]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=[repr(s) for s in BAD_SPECS])
def test_from_spec_errors_match_jax(spec):
    with pytest.raises(Exception) as jerr:
        jfilter.Filter.from_spec(spec)
    with pytest.raises(jerr.type) as terr:
        tfilter.Filter.from_spec(spec)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", [{"nope": 1}, {"shop": {"range": [0, 1]}}])
def test_compile_errors_match_jax(stores, spec):
    _, js, ts = stores
    with pytest.raises(Exception) as jerr:
        jfilter.compile_mask(jfilter.Filter.from_spec(spec), js)
    with pytest.raises(jerr.type) as terr:
        tfilter.compile_mask(tfilter.Filter.from_spec(spec), ts, CPU)
    assert str(terr.value) == str(jerr.value)


def test_resolve_mask_errors_match_jax(stores):
    _, js, ts = stores
    for bad, store in ((np.ones(N - 1, bool), ts), ({"price": 1.0}, None)):
        with pytest.raises(Exception) as jerr:
            jfilter.resolve_mask(bad, js if store is not None else None, N)
        with pytest.raises(jerr.type) as terr:
            tfilter.resolve_mask(bad, store, N, CPU)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("frac", [0.0, 0.003, 0.1, 0.37, 0.5, 0.999, 1.0])
def test_selectivity_arithmetic_matches_jax(frac):
    mask = np.random.default_rng(1).uniform(size=1000) < frac
    sel = tfilter.selectivity(torch.as_tensor(mask))
    assert sel == jfilter.selectivity(jnp.asarray(mask))
    b = tfilter.bucket_selectivity(sel)
    assert b == jfilter.bucket_selectivity(sel)
    for K, n in ((10, 1000), (64, 60000), (256, 2048), (1, 1)):
        for s in (sel, b, frac):
            assert tfilter.scaled_width(K, s, n) == jfilter.scaled_width(K, s, n)


def test_store_round_trips_and_mutates_like_jax(stores):
    _, js, ts = stores
    # JAX's snapshot loads into the port, and the port's into itself
    arrays, statics = js.snapshot_state()
    loaded = convert.attrs_from_jax_state(arrays, statics)
    tarr, tstat = ts.snapshot_state()
    assert tstat == statics and set(tarr) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(tarr[key], arrays[key])
        np.testing.assert_array_equal(loaded.snapshot_state()[0][key], arrays[key])
    again = tattrs.AttributeStore.from_snapshot(tarr, tstat)
    assert again.columns() == ts.columns() == js.columns() and again.n == N
    assert ts.memory_bytes() == js.memory_bytes()
    # take, set_rows and to_values as JAX does them
    idx = np.arange(0, N, 3)
    jt, tt = js.take(idx, capacity=idx.size + 5), ts.take(idx, capacity=idx.size + 5)
    new = {"price": [0.5, np.nan], "shop": ["s9", None]}
    jt.set_rows(idx.size, new, 2)
    tt.set_rows(idx.size, new, 2)
    np.testing.assert_equal(tt.to_values(), jt.to_values())
    assert tt.categorical["shop"][1] == jt.categorical["shop"][1]
    for bad in ({"nope": [1, 2]}, {"price": [1.0]}):
        with pytest.raises(Exception) as jerr:
            jt.validate_rows(bad, 2)
        with pytest.raises(jerr.type):
            tt.validate_rows(bad, 2)


def test_mutation_drops_the_caches(stores):
    vals, _, _ = stores
    ts = tattrs.AttributeStore.build(vals, N)
    spec = {"count": 3}
    m1 = tfilter.resolve_mask(spec, ts, N, CPU)
    assert tfilter.resolve_mask(spec, ts, N, CPU) is m1  # compiled once
    tfilter.cached_selectivity(spec, ts, m1)
    ts.set_rows(0, {"count": [3]}, 1)
    assert not ts.mask_cache and not ts.sel_cache and ts._dev is None
    assert bool(tfilter.resolve_mask(spec, ts, N, CPU)[0])


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N, 20)).astype(np.float32)
    Q = rng.normal(size=(10, 20)).astype(np.float32)
    return X, Q, _values(N, seed=2)


BRUTE_FILTERS = [{"price": {"range": [None, 0.5]}}, {"price": {"range": [0.0, 0.05]}},
                 {"shop": ["s1", "s4"], "count": {"range": [1, 5]}}]


def _impl(quant: bool, passing: int) -> dict:
    """JAX's quantized brute through its Pallas int8 kernel (the function
    the port computes), except where fewer rows pass than the shortlist
    holds: there the Pallas kernel leaves stale ids (pinned below) and every
    passing row reaches the exact rerank in either first pass, so JAX's jnp
    path gives the answer."""
    if not quant:
        return {}
    return {"quant": True, "impl": "pallas" if passing >= K_QUANT else "jnp"}


K_QUANT = tquant.shortlist_width(10, N)  # 64


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quant"])
@pytest.mark.parametrize("spec", BRUTE_FILTERS, ids=[str(s) for s in BRUTE_FILTERS])
def test_filtered_brute_matches_jax_and_the_sub_corpus(corpus, quant, spec):
    X, Q, vals = corpus
    teng = tindex.build("brute", X, {"attrs": vals, "quant": quant}, device=CPU)
    mask = to_np(tfilter.resolve_mask(spec, teng.attrs, N, CPU))
    jr = jindex.build("brute", X, {"attrs": vals} | _impl(quant, int(mask.sum()))).search(
        Q, k=10, filter=spec)
    tr = teng.search(Q, k=10, filter=spec)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    ids = to_np(tr.idx)
    assert mask[ids[ids >= 0]].all()  # leaked == 0
    # the scan over the passing rows, ids mapped back (for the quantized
    # scan: where every passing row fits in the shortlist)
    if not quant or mask.sum() <= K_QUANT:
        sub = tindex.build("brute", X[mask], {}, device=CPU).search(Q, k=10)
        rows = np.where(mask)[0]
        sid = to_np(sub.idx)
        assert_same_ids(tr.idx, tr.dist, np.where(sid >= 0, rows[np.maximum(sid, 0)], -1),
                        sub.dist)
    assert (to_np(tr.comparisons) == mask.sum() + (K_QUANT if quant else 0)).all()


def test_jax_pallas_int8_leaves_stale_ids_under_a_narrow_filter(corpus):
    """A reference fault, pinned: with fewer passing rows than the shortlist
    (13 < 64), JAX's Pallas int8 kernel fills the slots past them with
    stale ids, which the rerank then returns more than once; the port (and
    JAX's jnp path) return the 10 distinct nearest passing rows."""
    X, Q, vals = corpus
    spec = BRUTE_FILTERS[1]
    jr = jindex.build("brute", X, {"attrs": vals, "quant": True, "impl": "pallas"}).search(
        Q, k=10, filter=spec)
    assert all(len(set(row)) < 10 for row in np.asarray(jr.idx).tolist())
    tr = tindex.build("brute", X, {"attrs": vals, "quant": True}, device=CPU).search(
        Q, k=10, filter=spec)
    assert all(len(set(row)) == 10 for row in to_np(tr.idx).tolist())


def test_filter_as_default_and_as_raw_masks(corpus):
    X, Q, vals = corpus
    spec = {"price": {"range": [0.25, 0.75]}}
    teng = tindex.build("brute", X, {"attrs": vals, "filter": spec}, device=CPU)
    want = teng.search(Q, k=6)
    mask = to_np(tfilter.resolve_mask(spec, teng.attrs, N, CPU))
    plain = tindex.build("brute", X, {}, device=CPU)
    for raw in (mask, torch.as_tensor(mask), mask.astype(np.int8)):
        got = plain.search(Q, k=6, filter=raw)
        assert torch.equal(got.idx, want.idx) and torch.equal(got.comparisons,
                                                              want.comparisons)
    assert tindex.side_store_bytes(teng) == teng.attrs.memory_bytes()
    with pytest.raises(TypeError, match="no attribute store"):
        plain.search(Q, k=6, filter=spec)


@pytest.fixture(scope="module")
def infinity_pair():
    X = synthetic.make("clustered", 620, d=16, num_clusters=6, seed=0)
    X, Q = X[:560], X[560:]
    vals = _values(560, seed=3)
    jidx = JaxIndex.build(jnp.asarray(X), REDUCED)
    jindex.attach_store(jidx, jattrs.AttributeStore.build(vals, 560))
    arrays, statics = jidx.snapshot_state()
    tidx = convert.index_from_jax_state(jax.tree_util.tree_map(np.asarray, arrays), statics,
                                        device=CPU)
    tindex.attach_store(tidx, convert.attrs_from_jax_state(*jidx.attrs.snapshot_state()))
    return jidx, tidx, Q


@pytest.mark.parametrize("mode,k,kw", [
    ("beam", 5, {"budget": 300, "rerank": 32}),
    ("beam", 10, {}),
    ("best_first", 5, {"budget": 200, "rerank": 32}),
    ("best_first", 5, {"budget": 150}),
    ("auto", 1, {}),  # descent is disabled under a mask
])
@pytest.mark.parametrize("spec", [{"price": {"range": [None, 0.5]}},
                                  {"price": {"range": [None, 0.1]}, "shop": ["s0", "s1", "s2"]}])
def test_filtered_infinity_matches_jax(infinity_pair, mode, k, kw, spec):
    jidx, tidx, Q = infinity_pair
    jr = jidx.search(jnp.asarray(Q), k=k, mode=mode, filter=spec, **kw)
    tr = tidx.search(Q, k=k, mode=mode, filter=spec, **kw)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    mask = to_np(tfilter.resolve_mask(spec, tidx.attrs, tidx.X.shape[0], CPU))
    ids = to_np(tr.idx)
    assert mask[ids[ids >= 0]].all()  # leaked == 0
