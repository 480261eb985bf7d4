"""Port parity: the topk kernel module, ``core/scan``, ``core/knn_graph`` and
``core/quant`` against the JAX package (its ``ref.py`` oracle, the Pallas
kernel in interpret mode and the jnp scan), on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import knn_graph as jknn  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import scan as jscan  # noqa: E402
from repro.data import synthetic  # noqa: E402
from repro.kernels.topk.ref import topk_ref as jtopk_ref  # noqa: E402
from repro.kernels.topk.topk import topk_pallas  # noqa: E402
from repro_torch.core import knn_graph as tknn  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.kernels.topk.ref import topk_ref  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

MATMUL = ["sqeuclidean", "euclidean", "cosine", "dot"]


def _data(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _against_jax(X, Y, k, metric="sqeuclidean", exclude_self=False, valid=None,
                 pallas=True):
    """Port plain topk vs the JAX oracle and (optionally) the Pallas kernel."""
    out = topk_ref(torch.as_tensor(X), torch.as_tensor(Y), k=k, metric=metric,
                   exclude_self=exclude_self,
                   valid=None if valid is None else torch.as_tensor(valid))
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32
    if valid is None:
        rd, ri = jtopk_ref(jnp.asarray(X), jnp.asarray(Y), k=k, metric=metric,
                           exclude_self=exclude_self)
        assert_same_ids(out[1], out[0], ri, rd)
    if pallas:
        pd, pi = topk_pallas(jnp.asarray(X), jnp.asarray(Y), k=k, metric=metric,
                             exclude_self=exclude_self,
                             valid=None if valid is None else jnp.asarray(valid),
                             interpret=True)
        assert_same_ids(out[1], out[0], pi, pd)
    return out


@pytest.mark.parametrize("metric", MATMUL + ["manhattan", "chebyshev"])
def test_topk_plain_all_metrics(metric):
    X, Y = _data(40, 300, 24, seed=1)
    _against_jax(X, Y, 10, metric=metric, pallas=metric in MATMUL)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (33, 257, 20, 5),
                                   (130, 129, 7, 17), (8, 4096, 128, 64)])
def test_topk_plain_ragged_shapes(shape):
    m, n, d, k = shape
    X, Y = _data(m, n, d, seed=2)
    _against_jax(X, Y, k)


def test_topk_plain_k_exceeds_n():
    X, Y = _data(6, 10, 4, seed=3)
    d, i = _against_jax(X, Y, 25, metric="euclidean")
    assert torch.isinf(d[:, 10:]).all() and (i[:, 10:] == -1).all()
    assert (i[:, :10] >= 0).all()


def test_topk_plain_duplicate_ties_pick_lowest_index():
    base = np.random.default_rng(4).normal(size=(20, 8)).astype(np.float32)
    Y = np.concatenate([base, base, base])
    d, i = _against_jax(base[:7], Y, 9)
    # exact ties: identical ids, lowest copy first
    rd, ri = jtopk_ref(jnp.asarray(base[:7]), jnp.asarray(Y), k=9, metric="sqeuclidean")
    assert np.array_equal(to_np(i), to_np(ri))
    assert (to_np(i)[:, 0] == np.arange(7)).all()


def test_topk_plain_exclude_self_beyond_valid_candidates():
    X, _ = _data(5, 1, 4, seed=11)
    d, i = _against_jax(X, X, 5, exclude_self=True)
    assert (i[:, -1] == -1).all() and torch.isinf(d[:, -1]).all()


def test_topk_plain_valid_mask_matches_pallas():
    X, Y = _data(9, 64, 8, seed=7)
    valid = np.arange(64) % 3 != 0
    d, i = _against_jax(X, Y, 5, metric="euclidean", valid=valid)
    assert not np.isin(to_np(i), np.arange(0, 64, 3)).any()


CUBE_CASES = [  # (m, n, d, k, exclude_self, masked): ragged tails in m, n and d
    (33, 257, 20, 5, False, False),
    (40, 300, 37, 10, False, True),
    (130, 130, 9, 17, True, False),
    (64, 64, 8, 5, True, True),
]


@pytest.mark.parametrize("metric", ["manhattan", "chebyshev"])
@pytest.mark.parametrize("case", CUBE_CASES)
def test_topk_plain_cube_matches_pallas_cube_kernel(metric, case):
    """The cube regime's plain version against the JAX ``_cube_kernel`` in
    interpret mode: masks, self-exclusion and ragged tiles.  Chebyshev is a
    max of exact differences, so its distances are identical; manhattan
    sums in another order (rtol 1e-5 / atol 5e-4)."""
    m, n, d, k, excl, masked = case
    rng = np.random.default_rng([m, n, d])
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = X if excl else rng.normal(size=(n, d)).astype(np.float32)
    valid = (np.arange(n) % 4 != 1) if masked else None
    d_, i_ = _against_jax(X, Y, k, metric=metric, exclude_self=excl, valid=valid)
    if metric == "chebyshev":
        pd, pi = topk_pallas(jnp.asarray(X), jnp.asarray(Y), k=k, metric=metric,
                             exclude_self=excl,
                             valid=None if valid is None else jnp.asarray(valid),
                             interpret=True)
        np.testing.assert_array_equal(to_np(d_), np.asarray(pd))
    if excl:
        assert (to_np(i_) != np.arange(m)[:, None]).all()
    if masked:
        assert not np.isin(to_np(i_), np.arange(1, n, 4)).any()


def test_topk_plain_cube_blocks_its_intermediate(monkeypatch):
    """The plain cube form takes X in row blocks that bound the (rows, n, d)
    |x - y| intermediate; the blocked answer is the unblocked one."""
    from repro_torch.kernels.pdist import ref as pdist_ref_mod

    X, Y = _data(50, 200, 12, seed=13)
    whole = topk_ref(torch.as_tensor(X), torch.as_tensor(Y), k=6, metric="manhattan")
    monkeypatch.setattr(pdist_ref_mod, "CUBE_BLOCK_BYTES", 4 * 200 * 12 * 7)
    assert pdist_ref_mod.cube_rows(200, 12) == 7
    blocked = topk_ref(torch.as_tensor(X), torch.as_tensor(Y), k=6, metric="manhattan")
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


@pytest.mark.parametrize("block", [16, 4096])
def test_topk_scan_matches_jax_scan(block):
    X, Y = _data(25, 500, 16, seed=5)
    valid = np.arange(500) % 7 != 0
    out = tscan.topk_scan(torch.as_tensor(X), torch.as_tensor(Y), k=12,
                          valid=torch.as_tensor(valid), block=block)
    ref = jscan.topk_scan(jnp.asarray(X), jnp.asarray(Y), k=12,
                          valid=jnp.asarray(valid), block=block)
    assert_same_ids(out[1], out[0], ref[1], ref[0])


@pytest.mark.parametrize("metric", ["jaccard", "correlation"])
def test_topk_scan_metrics_without_kernel(metric):
    rng = np.random.default_rng(6)
    X = (rng.random((12, 30)) > 0.5).astype(np.float32)
    out = tscan.topk_scan(torch.as_tensor(X), torch.as_tensor(X), k=4, metric=metric,
                          block=8, exclude_self=True)
    ref = jscan.topk_scan(jnp.asarray(X), jnp.asarray(X), k=4, metric=metric,
                          block=8, exclude_self=True)
    assert_same_ids(out[1], out[0], ref[1], ref[0])


def _lists(seed, B=4, S=3, kk=5, n=100, pad=0):
    rng = np.random.default_rng(seed)
    d = np.sort(rng.uniform(0, 1, size=(B, S, kk)).astype(np.float32), axis=-1)
    i = rng.integers(0, n, size=(B, S, kk)).astype(np.int32)
    if pad:
        d[:, :, -pad:] = np.inf
        i[:, :, -pad:] = -1
    return d, i


@pytest.mark.parametrize("case", ["plain", "k_exceeds", "padding", "ties"])
def test_merge_topk_matches_jax(case):
    d, i = _lists(8, pad=2 if case in ("k_exceeds", "padding") else 0)
    k = 20 if case == "k_exceeds" else 6
    if case == "padding":
        d[1] = np.inf
        i[1] = -1
    if case == "ties":
        d[:, 1] = d[:, 0]
    out = tscan.merge_topk(torch.as_tensor(d), torch.as_tensor(i), k=k)
    ref = jscan.merge_topk(jnp.asarray(d), jnp.asarray(i), k=k)
    np.testing.assert_array_equal(to_np(out[1]), to_np(ref[1]))
    np.testing.assert_array_equal(to_np(out[0]), to_np(ref[0]))


@pytest.mark.parametrize("k", [3, 40])
def test_topk_candidates_batched_matches_vmapped_jax(k):
    X, Q = _data(200, 6, 10, seed=9)
    rng = np.random.default_rng(10)
    cand = rng.integers(0, 200, size=(6, 32)).astype(np.int32)
    cand[:, -5:] = -1
    cand[2] = -1
    cand[3, :4] = cand[3, 4:8]  # duplicated candidates tie exactly
    out = tscan.topk_candidates(torch.as_tensor(Q), torch.as_tensor(cand),
                                torch.as_tensor(X), k=k, metric="euclidean")
    ref = jax.vmap(lambda q, c: jscan.topk_candidates(
        q, c, jnp.asarray(X), k=k, metric="euclidean"))(jnp.asarray(Q), jnp.asarray(cand))
    assert out[0].dtype == torch.int32
    assert_same_ids(out[0], out[1], ref[0], ref[1])
    assert (to_np(out[0])[2] == -1).all()


@pytest.mark.parametrize("n,k", [(512, 16), (300, 8)])
def test_knn_graph_ids_identical_at_build_sizes(n, k):
    S = synthetic.make("manifold", n, seed=3)
    ti, td = tknn.knn_graph(torch.as_tensor(S), k=k)
    ji, jd = jknn.knn_graph(jnp.asarray(S), k=k)
    assert_same_ids(ti, td, ji, jd)
    assert np.array_equal(to_np(tknn.knn_mask(ti, n)), to_np(jknn.knn_mask(ji, n)))


def test_pow2ceil_and_shortlist_width_match_jax():
    for x in (1, 2, 3, 31, 32, 33, 1000):
        assert tscan.pow2ceil(x) == jscan.pow2ceil(x)
    for k, n in ((10, 60000), (10, 100), (1, 5), (64, 4096)):
        for mult in (4, 8):
            assert (tquant.shortlist_width(k, n, mult=mult)
                    == jquant.shortlist_width(k, n, mult=mult))


@pytest.mark.parametrize("axis", [None, 0])
def test_quant_codes_bit_identical(axis):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(50, 16)).astype(np.float32)
    x[3] = 0.5 * np.abs(x).max()  # exercise round-half-to-even neighbourhoods
    ts = tquant.absmax_scales(torch.as_tensor(x), axis=axis)
    js = jquant.absmax_scales(jnp.asarray(x), axis=axis)
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    tc = tquant.encode(torch.as_tensor(x), ts)
    jc = jquant.encode(jnp.asarray(x), js)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(to_np(tc), to_np(jc))
    np.testing.assert_array_equal(to_np(tquant.decode(tc, ts)), to_np(jquant.decode(jc, js)))
