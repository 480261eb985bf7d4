"""Port parity: ``core/quant`` (``QuantStore``, ``fake_quant``), the int8
topk kernel module (its plain version), ``core/scan.topk_scan_quant`` /
``quant_candidates`` and the infinity engine's int8 prefilter against the
JAX package, on the CPU.

The port computes the int8 kernel's function — JAX's ``topk_scan_quant(...,
impl="pallas")``, run here in interpret mode — whose query is quantised
too.  Tolerances: codes and scales bit-identical; squared norms rtol 1e-5
(the two packages sum them in different orders); int8 distances rtol and
atol 1e-4 (``tests/test_quant.py:108-110``), ids identical except on near
ties (``torch_parity.assert_same_ids``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.infinity_search import REDUCED  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import scan as jscan  # noqa: E402
from repro.core.search import InfinityIndex as JaxIndex  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
QTOL = dict(rtol=1e-4, atol=1e-4)
N, D = 512, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Q = rng.normal(size=(16, D)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def stores(data):
    """(JAX store, the port store built from the same X on the CPU)."""
    X, _ = data
    return jquant.QuantStore.build(X), tquant.QuantStore.build(torch.as_tensor(X))


def test_store_codes_and_scales_bit_identical(stores):
    js, ts = stores
    assert ts.codes.dtype == np.int8 and ts.scales.dtype == np.float32
    np.testing.assert_array_equal(ts.codes, js.codes)
    np.testing.assert_array_equal(ts.scales, js.scales)
    assert (ts.rows, ts.dim) == (js.rows, js.dim)
    assert ts.memory_bytes() == js.memory_bytes()


def test_store_device_view_norms(stores):
    js, ts = stores
    jc, jsc, jn = js.device_view()
    tc, tsc, tn = ts.device_view()
    assert tc.dtype == torch.int8 and tc.device.type == "cpu"
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(tsc), np.asarray(jsc))
    np.testing.assert_allclose(to_np(tn), np.asarray(jn), rtol=1e-5)
    assert ts.device_view()[0] is tc  # one upload per mutation


def test_store_from_numpy_defaults_to_cuda(monkeypatch, data):
    X, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tquant.QuantStore.build(X)
    assert tquant.QuantStore.build(X, device=CPU).device == torch.device(CPU)


@pytest.mark.parametrize("shape", [(77,), (9, 13)])
def test_fake_quant_matches_jax(shape):
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(to_np(tquant.fake_quant(torch.as_tensor(g))),
                                  np.asarray(jquant.fake_quant(jnp.asarray(g))))


def test_store_take_set_rows_and_snapshot_match_jax(data):
    X, _ = data
    js = jquant.QuantStore.build(X)
    ts = tquant.QuantStore.build(torch.as_tensor(X))
    idx = np.array([5, 0, 17, 511, 5])
    jt, tt = js.take(idx, capacity=8), ts.take(idx, capacity=8)
    np.testing.assert_array_equal(tt.codes, jt.codes)
    np.testing.assert_array_equal(tt.scales, jt.scales)
    with pytest.raises(ValueError, match="capacity"):
        ts.take(idx, capacity=2)
    # set_rows quantizes under the EXISTING scales (values past them clip),
    # into a slot buffer as the live subsystem takes one
    new = 3.0 * np.random.default_rng(2).normal(size=(4, D)).astype(np.float32)
    js, ts = js.take(np.arange(N), capacity=N + 8), ts.take(np.arange(N), capacity=N + 8)
    tc0 = ts.device_view()[0]
    js.set_rows(N + 2, new, 4)
    ts.set_rows(N + 2, new, 4)
    np.testing.assert_array_equal(ts.codes, js.codes)
    assert ts.device_view()[0] is not tc0  # the mutation invalidated the view
    np.testing.assert_array_equal(to_np(ts.device_view()[0]), js.codes)
    # snapshots cross in both directions
    arrays, statics = js.snapshot_state()
    back = convert.quant_store_from_jax(arrays, device=CPU)
    np.testing.assert_array_equal(back.codes, js.codes)
    np.testing.assert_array_equal(back.scales, js.scales)
    tarr, tstat = ts.snapshot_state()
    jback = jquant.QuantStore.from_snapshot(tarr, tstat)
    np.testing.assert_array_equal(jback.codes, ts.codes)


def test_query_quantisation_matches_the_jax_kernel_entry(stores, data):
    """``quantize_queries`` forms xq, alpha and |q|^2 as
    ``repro/kernels/topk/topk.py:404-408`` does."""
    js, ts = stores
    _, Q = data
    xq, alpha, xn = quantize_queries(torch.as_tensor(Q), torch.as_tensor(ts.scales))
    xs = jnp.asarray(Q) * jnp.asarray(js.scales)[None, :]
    jalpha = jquant.absmax_scales(xs, axis=1, keepdims=True)
    np.testing.assert_array_equal(to_np(alpha), np.asarray(jalpha)[:, 0])
    np.testing.assert_array_equal(to_np(xq), np.asarray(jquant.encode(xs, jalpha)))
    np.testing.assert_allclose(to_np(xn), (Q * Q).sum(1), rtol=1e-6)


def _jax_quant_scan(Q, js, **kw):
    codes, scales, sqn = js.device_view()
    return jscan.topk_scan_quant(jnp.asarray(Q), codes, scales, impl="pallas",
                                 sqnorms=sqn, **kw)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("masked", [False, True])
def test_topk_scan_quant_matches_jax_pallas(stores, data, metric, masked):
    js, ts = stores
    _, Q = data
    valid = (np.arange(N) % 5 != 0) if masked else None
    codes, scales, sqn = ts.device_view()
    before = _build.launches()
    out = tscan.topk_scan_quant(torch.as_tensor(Q), codes, scales, k=9, metric=metric,
                                sqnorms=sqn,
                                valid=None if valid is None else torch.as_tensor(valid))
    assert _build.launches() == before  # CPU tensors take the plain version
    ref = _jax_quant_scan(Q, js, k=9, metric=metric,
                          valid=None if valid is None else jnp.asarray(valid))
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32
    assert_same_ids(out[1], out[0], ref[1], ref[0], **QTOL)
    if masked:
        assert not np.isin(to_np(out[1]), np.arange(0, N, 5)).any()


@pytest.mark.parametrize("n,d,k", [(301, 21, 7), (40, 8, 64), (129, 64, 33)])
def test_topk_quant_plain_ragged_shapes(n, d, k):
    """Ragged n (not a tile multiple), d not a multiple of 4, k > n; the
    store's norms recomputed when the caller passes none."""
    rng = np.random.default_rng([n, d, k])
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(11, d)).astype(np.float32)
    js = jquant.QuantStore.build(X)
    ts = tquant.QuantStore.build(torch.as_tensor(X))
    codes, scales, _ = ts.device_view()
    out = topk_ops.topk_quant(torch.as_tensor(Q), codes, scales, k=k, metric="euclidean")
    ref = _jax_quant_scan(Q, js, k=k, metric="euclidean")
    assert_same_ids(out[1], out[0], ref[1], ref[0], **QTOL)
    if k > n:
        assert (to_np(out[1])[:, n:] == -1).all() and torch.isinf(out[0][:, n:]).all()


def test_topk_quant_plain_cross_term_is_exact():
    """The plain version's cross term is exact where an f32 matmul is not
    (127^2 * d > 2^24 from d = 1041): every code at +-127."""
    d = 1100
    codes = torch.full((3, d), 127, dtype=torch.int8)
    codes[1] = -127
    scales = torch.full((d,), 1.0 / 127.0)
    Q = torch.full((2, d), 1.0)
    sqn = (tquant.decode(codes, scales) ** 2).sum(1)
    dist, idx = topk_quant_ref(Q, codes, scales, sqn, k=3, metric="sqeuclidean")
    # acc = +-127^2 * d exactly, alpha = 1/127: cross = +-127 * d
    assert idx[0].tolist() == [0, 2, 1]
    np.testing.assert_allclose(to_np(dist[0]), [0.0, 0.0, 4.0 * d], rtol=1e-6)


def test_topk_quant_ties_across_a_tile_boundary_pick_the_lowest_column():
    """Duplicate corpus rows 192 apart, on both sides of the 128-column
    tile boundary that JAX's kernel and the port's scan both cut at: their
    codes and norms are equal, so they tie exactly and the lower column
    comes first — in JAX's Pallas kernel (interpret mode), in the plain
    version, and in the plain version at another panel width, bit for bit
    (the int8 kernel's contract on the card)."""
    rng = np.random.default_rng(16)
    base = rng.normal(size=(192, 32)).astype(np.float32)
    X = np.concatenate([base, base])  # row j and j + 192
    Q = base[120:128] + 0.01 * rng.normal(size=(8, 32)).astype(np.float32)
    js = jquant.QuantStore.build(X)
    ts = tquant.QuantStore.build(torch.as_tensor(X))
    codes, scales, sqn = ts.device_view()
    out = topk_quant_ref(torch.as_tensor(Q), codes, scales, sqn, k=6, metric="euclidean")
    ref = _jax_quant_scan(Q, js, k=6, metric="euclidean")
    assert_same_ids(out[1], out[0], ref[1], ref[0], **QTOL)
    want = np.arange(120, 128)[:, None] + np.array([0, 192])
    np.testing.assert_array_equal(to_np(out[1])[:, :2], want)
    np.testing.assert_array_equal(np.asarray(ref[1])[:, :2], want)
    narrow = topk_quant_ref(torch.as_tensor(Q), codes, scales, sqn, k=6,
                            metric="euclidean", block=64)
    assert torch.equal(narrow[0], out[0]) and torch.equal(narrow[1], out[1])


@pytest.mark.parametrize("metric", ["cosine", "manhattan"])
def test_topk_scan_quant_dequant_path_matches_jax(stores, data, metric):
    """Metrics outside the int8 regime dequantise one block at a time, as
    JAX does under ``impl="pallas"``."""
    js, ts = stores
    _, Q = data
    codes, scales, _ = ts.device_view()
    valid = np.arange(N) % 3 != 1
    out = tscan.topk_scan_quant(torch.as_tensor(Q), codes, scales, k=6, metric=metric,
                                valid=torch.as_tensor(valid), block=64)
    ref = _jax_quant_scan(Q, js, k=6, metric=metric, valid=jnp.asarray(valid), block=64)
    assert_same_ids(out[1], out[0], ref[1], ref[0])


@pytest.mark.parametrize("k", [4, 40])
def test_quant_candidates_matches_vmapped_jax(stores, data, k):
    js, ts = stores
    _, Q = data
    rng = np.random.default_rng(10)
    cand = rng.integers(0, N, size=(Q.shape[0], 32)).astype(np.int32)
    cand[:, -5:] = -1
    cand[2] = -1
    cand[3, :4] = cand[3, 4:8]  # duplicated candidates tie exactly
    codes, scales, _ = ts.device_view()
    out = tscan.quant_candidates(torch.as_tensor(Q), torch.as_tensor(cand), codes,
                                 scales, k=k, metric="euclidean")
    jc, jsc, _ = js.device_view()
    ref = jax.vmap(lambda q, c: jscan.quant_candidates(
        q, c, jc, jsc, k=k, metric="euclidean"))(jnp.asarray(Q), jnp.asarray(cand))
    assert out[0].dtype == torch.int32
    assert_same_ids(out[0], out[1], ref[0], ref[1])
    assert (to_np(out[0])[2] == -1).all()


@pytest.fixture(scope="module")
def infinity_pair():
    """A JAX-built infinity index with its quant store attached, and the
    port index and store loaded from their states."""
    X = synthetic.make("clustered", 680, d=16, num_clusters=6, seed=0)
    X, Q = X[:600], X[600:]
    jidx = JaxIndex.build(jnp.asarray(X), dataclasses.replace(REDUCED, train_steps=60))
    arrays, statics = jidx.snapshot_state()
    tidx = convert.index_from_jax_state(jax.tree_util.tree_map(np.asarray, arrays),
                                        statics, device=CPU)
    jstore = jquant.QuantStore.build(X)
    jindex.attach_quant_store(jidx, jstore)
    tindex.attach_quant_store(
        tidx, convert.quant_store_from_jax(jstore.snapshot_state()[0], device=CPU))
    return jidx, tidx, Q


@pytest.mark.parametrize("mode,k,kw", [
    ("beam", 10, {"rerank": 256, "budget": 300}),
    ("beam", 5, {"rerank": 64}),
    ("best_first", 5, {"rerank": 128, "budget": 200}),
])
def test_infinity_quant_prefilter_matches_jax(infinity_pair, mode, k, kw):
    """Beam bucket scans on int8 codes of the embedding rows, and the rerank
    prefiltered on the store's codes (K > shortlist_width(k, n)): JAX's ids
    and comparisons."""
    jidx, tidx, Q = infinity_pair
    assert tquant.shortlist_width(k, 600) < max(kw["rerank"], 8 * k)  # prefilter runs
    jr = jidx.search(jnp.asarray(Q), k=k, mode=mode, **kw)
    tr = tidx.search(Q, k=k, mode=mode, **kw)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    zc = tidx._flat["zcodes"]
    np.testing.assert_array_equal(to_np(zc[0]), np.asarray(jidx._flat["zcodes"][0]))
    assert tidx.memory_bytes() == jidx.memory_bytes()


def test_registry_quant_key_builds_and_attaches_the_store(data):
    X, Q = data
    small = {"proj_sample": 64, "knn_k": 4, "num_hops": 2, "embed_dim": 4,
             "hidden": (8,), "train_steps": 5, "batch_pairs": 32, "rerank": 128}
    idx = tindex.build("infinity", X[:200], small | {"quant": True}, device=CPU)
    assert idx.quant is not None and idx.quant.rows == 200
    np.testing.assert_array_equal(idx.quant.codes, jquant.QuantStore.build(X[:200]).codes)
    plain = dataclasses.replace(idx, quant=None, _flat=None)
    a = idx.search(Q, k=10, mode="beam")
    b = plain.search(Q, k=10, mode="beam")
    assert a.idx.shape == (16, 10) and (a.comparisons == b.comparisons).all()
    assert idx.memory_bytes() == plain.memory_bytes() + idx.quant.memory_bytes() + \
        tindex.pytree_nbytes(idx._flat["zcodes"])
