"""Port parity: ``core/vptree`` against ``repro.core.vptree`` on the CPU.

The host builds are copies, so the same seed gives identical arrays; the
three batched searches run on a tree with identical arrays and must return
identical ids, comparison counts and (beam) stage counters."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import vptree as jvp  # noqa: E402
from repro_torch.core import vptree as tvp  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"


def _data(n=300, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(24, d)).astype(np.float32)
    return X, Q


def _assert_tree_equal(tt, jt):
    for name in ("vantage", "mu", "left", "right"):
        np.testing.assert_array_equal(to_np(getattr(tt, name)), np.asarray(getattr(jt, name)))
    assert tt.depth == jt.depth


@pytest.mark.parametrize("select", ["random", "spread"])
@pytest.mark.parametrize("seed", [0, 3])
def test_build_vptree_arrays_identical(select, seed):
    X, _ = _data(seed=seed)
    _assert_tree_equal(tvp.build_vptree(X, seed=seed, select=select, device=CPU),
                       jvp.build_vptree(X, seed=seed, select=select))


def test_build_vptree_on_precomputed_D_identical():
    X, _ = _data(120, seed=1)
    D = np.array(jmetrics.pairwise(jnp.asarray(X), jnp.asarray(X)))
    _assert_tree_equal(tvp.build_vptree(D=D, seed=2, device=CPU),
                       jvp.build_vptree(D=D, seed=2))


@pytest.mark.parametrize("leaf_size", [1, 8, 16])
@pytest.mark.parametrize("with_Z", [True, False])
def test_flatten_vptree_arrays_identical(leaf_size, with_Z):
    X, _ = _data(seed=4)
    jt = jvp.build_vptree(X, seed=4)
    tt = tvp.build_vptree(X, seed=4, device=CPU)
    jf = jvp.flatten_vptree(jt, leaf_size=leaf_size, Z=X if with_Z else None)
    tf = tvp.flatten_vptree(tt, leaf_size=leaf_size, Z=X if with_Z else None)
    for name in ("mu", "child_in", "child_out", "rad_in", "rad_out", "bucket_rows", "perm"):
        np.testing.assert_array_equal(to_np(getattr(tf, name)), np.asarray(getattr(jf, name)))
    if with_Z:
        np.testing.assert_array_equal(to_np(tf.centroids), np.asarray(jf.centroids))
    else:
        assert tf.centroids is None and jf.centroids is None
    assert (tf.depth, tf.leaf_size) == (jf.depth, jf.leaf_size)


def test_beam_plan_identical():
    for budget in (None, 1, 50, 300, 1024, 5000):
        for depth, nodes, nb, k in ((5, 31, 20, 10), (9, 600, 300, 1), (3, 4, 2, 64)):
            kw = dict(depth=depth, leaf_size=16, num_nodes=nodes, num_buckets=nb, k=k)
            assert tvp.beam_plan(budget, **kw) == jvp.beam_plan(budget, **kw)


def _trees(X, seed=0):
    return jvp.build_vptree(X, seed=seed), tvp.build_vptree(X, seed=seed, device=CPU)


def test_descend_identical():
    X, Q = _data(seed=5)
    jt, tt = _trees(X)
    ji, jd, jc = jvp.descend_infty(jt, jnp.asarray(Q), X=jnp.asarray(X))
    ti, td, tc = tvp.descend_infty(tt, torch.as_tensor(Q), X=torch.as_tensor(X))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_allclose(to_np(td), np.asarray(jd), rtol=1e-5)
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("q", [1.0, 2.0, 8.0, math.inf])
@pytest.mark.parametrize("k,budget", [(1, None), (5, 60), (10, 200)])
def test_best_first_identical(q, k, budget):
    X, Q = _data(seed=6)
    jt, tt = _trees(X, seed=6)
    ji, jd, jc, jtr = jvp.search_best_first(jt, jnp.asarray(Q), q=q, k=k, X=jnp.asarray(X),
                                            max_comparisons=budget, with_truncated=True)
    ti, td, tc, ttr = tvp.search_best_first(tt, torch.as_tensor(Q), q=q, k=k,
                                            X=torch.as_tensor(X), max_comparisons=budget,
                                            with_truncated=True)
    assert_same_ids(ti, td, ji, jd)
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(ttr), np.asarray(jtr))


def test_best_first_rows_mode_and_filter_identical():
    X, Q = _data(200, seed=7)
    jt, tt = _trees(X, seed=7)
    rows = np.array(jmetrics.pairwise(jnp.asarray(Q), jnp.asarray(X)))
    valid = np.arange(200) % 4 != 1
    ji, jd, jc = jvp.search_best_first(jt, jnp.asarray(rows), q=4.0, k=3,
                                       valid=jnp.asarray(valid))
    ti, td, tc = tvp.search_best_first(tt, torch.as_tensor(rows), q=4.0, k=3,
                                       valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(td), np.asarray(jd))


def test_best_first_matches_reference_recursion():
    X, Q = _data(150, seed=8)
    _, tt = _trees(X, seed=8)
    ti, td, tc = tvp.search_best_first(tt, torch.as_tensor(Q), q=2.0, k=1,
                                       X=torch.as_tensor(X))
    for b in range(Q.shape[0]):
        ri, rd, rc = tvp.search_reference(tt, Q[b], q=2.0, X=X)
        assert (ri, rc) == (int(ti[b, 0]), int(tc[b]))
        jr = jvp.search_reference(jvp.build_vptree(X, seed=8), Q[b], q=2.0, X=X)
        assert (ri, rc) == (jr[0], jr[2])


@pytest.mark.parametrize("q", [2.0, math.inf])
@pytest.mark.parametrize("budget,k", [(None, 1), (120, 5), (400, 16)])
def test_beam_identical_with_stage_counters(q, budget, k):
    X, Q = _data(400, seed=9)
    jt, tt = _trees(X, seed=9)
    jf = jvp.flatten_vptree(jt, leaf_size=8, Z=X)
    tf = tvp.flatten_vptree(tt, leaf_size=8, Z=X)
    Xf = X[np.asarray(jf.perm)]
    ji, jd, jc, js = jvp.search_beam(jf, jnp.asarray(Q), q=q, k=k, X=jnp.asarray(Xf),
                                     max_comparisons=budget, with_stages=True)
    ti, td, tc, ts = tvp.search_beam(tf, torch.as_tensor(Q), q=q, k=k,
                                     X=torch.as_tensor(Xf), max_comparisons=budget,
                                     with_stages=True)
    assert_same_ids(ti, td, ji, jd)
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    for name in ("traversal", "centroid_rank", "bucket_scan"):
        np.testing.assert_array_equal(to_np(ts[name]), np.asarray(js[name]))


def test_beam_rows_mode_knobs_and_filter_identical():
    X, Q = _data(250, seed=10)
    jt, tt = _trees(X, seed=10)
    jf = jvp.flatten_vptree(jt, leaf_size=4)
    tf = tvp.flatten_vptree(tt, leaf_size=4)
    rows = np.array(jmetrics.pairwise(jnp.asarray(Q), jnp.asarray(X)))
    valid = np.arange(250) % 5 != 0
    kw = dict(q=4.0, k=6, beam_width=4, bucket_cap=6)
    ji, jd, jc = jvp.search_beam(jf, jnp.asarray(rows), valid=jnp.asarray(valid), **kw)
    ti, td, tc = tvp.search_beam(tf, torch.as_tensor(rows), valid=torch.as_tensor(valid), **kw)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(to_np(td), np.asarray(jd))
