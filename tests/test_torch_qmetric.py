"""Port parity: the qpath kernel module and ``core/qmetric`` against the JAX
package (``repro.kernels.qpath.ref``, the Pallas kernel in interpret mode,
``repro.core.qmetric``), on the CPU.  minmax and minplus are bit-identical
(min, max and a single f32 sum are exact); logminplus agrees to 1e-5."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import knn_graph as jknn  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import qmetric as jq  # noqa: E402
from repro.kernels.qpath.qpath import qpath_matmul_pallas  # noqa: E402
from repro.kernels.qpath.ref import qpath_matmul_ref as jqpath_ref  # noqa: E402
from repro_torch.core import qmetric as tq  # noqa: E402
from repro_torch.kernels.qpath.ref import qpath_matmul_ref  # noqa: E402
from torch_parity import to_np  # noqa: E402

SHAPES = [(32, 48, 16), (128, 128, 128), (130, 70, 257), (8, 300, 9)]  # test_kernels.py
MODES = ["minplus", "minmax", "logminplus"]
QS = [1.0, 2.0, 8.0, math.inf]
INF = math.inf


def _check(out, ref, mode):
    if mode == "logminplus":
        np.testing.assert_allclose(to_np(out), to_np(ref), atol=1e-5)
    else:
        np.testing.assert_array_equal(to_np(out), to_np(ref))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_qpath_plain_matches_jax_ref_and_pallas(shape, mode):
    m, k, n = shape
    rng = np.random.default_rng([*shape, MODES.index(mode)])
    A = rng.uniform(0.05, 4.0, size=(m, k)).astype(np.float32)
    B = rng.uniform(0.05, 4.0, size=(k, n)).astype(np.float32)
    A[rng.random((m, k)) < 0.2] = INF
    out = qpath_matmul_ref(torch.as_tensor(A), torch.as_tensor(B), mode=mode)
    _check(out, jqpath_ref(jnp.asarray(A), jnp.asarray(B), mode=mode), mode)
    _check(out, qpath_matmul_pallas(jnp.asarray(A), jnp.asarray(B), mode=mode,
                                    interpret=True), mode)


@pytest.mark.parametrize("mode", MODES)
def test_qpath_inf_identity_padding(mode):
    A = np.asarray([[0.0, INF], [1.0, 2.0]], np.float32)
    B = np.asarray([[0.5, INF], [INF, 1.0]], np.float32)
    out = qpath_matmul_ref(torch.as_tensor(A), torch.as_tensor(B), mode=mode)
    _check(out, jqpath_ref(jnp.asarray(A), jnp.asarray(B), mode=mode), mode)
    _check(out, qpath_matmul_pallas(jnp.asarray(A), jnp.asarray(B), mode=mode,
                                    interpret=True), mode)


def test_logminplus_minus_inf_diagonal():
    """The log-domain edge matrix has q*log(0) = -inf on its diagonal, so
    (-inf, -inf) pairs meet in every sweep: no NaN, JAX's values."""
    L = np.asarray([[-INF, 1.0, INF], [1.0, -INF, 2.0], [INF, 2.0, -INF]], np.float32)
    out = qpath_matmul_ref(torch.as_tensor(L), torch.as_tensor(L), mode="logminplus")
    assert not torch.isnan(out).any()
    _check(out, jqpath_ref(jnp.asarray(L), jnp.asarray(L), mode="logminplus"), "logminplus")
    _check(out, qpath_matmul_pallas(jnp.asarray(L), jnp.asarray(L), mode="logminplus",
                                    interpret=True), "logminplus")


def _dissimilarity(n, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    D = np.array(jmetrics.pairwise(jnp.asarray(X), jnp.asarray(X)))
    np.fill_diagonal(D, 0.0)
    return ((D + D.T) / 2).astype(np.float32)


@pytest.mark.parametrize("row_block", [1, 32])
@pytest.mark.parametrize("mode", MODES)
def test_semiring_matmul_matches_jax(mode, row_block):
    D = _dissimilarity(37, seed=1)
    A = jq.to_log_domain(jnp.asarray(D), 2.0) if mode == "logminplus" else jnp.asarray(D)
    ref = jq.semiring_matmul(A, A, mode=mode, row_block=row_block)
    At = torch.as_tensor(np.array(A))
    _check(tq.semiring_matmul(At, At, mode=mode, row_block=row_block), ref, mode)


@pytest.mark.parametrize("q", QS)
def test_canonical_projection_and_floyd_warshall_match_jax(q):
    D = _dissimilarity(40, seed=2)
    Dt = torch.as_tensor(D)
    ref = jq.canonical_projection(jnp.asarray(D), q)
    out = tq.canonical_projection(Dt, q)
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-5, atol=2e-5)
    fw = tq.floyd_warshall_reference(Dt, q)
    np.testing.assert_allclose(to_np(fw), to_np(jq.floyd_warshall_reference(jnp.asarray(D), q)),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(out), to_np(fw), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("schedule", ["bellman", "doubling"])
@pytest.mark.parametrize("q", [2.0, math.inf])
def test_sparse_projection_matches_jax(q, schedule):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 5)).astype(np.float32)
    D = np.array(jmetrics.pairwise(jnp.asarray(X), jnp.asarray(X)))
    np.fill_diagonal(D, 0.0)
    idx, _ = jknn.knn_graph(jnp.asarray(X), k=5)
    mask = np.array(jknn.knn_mask(idx, 64))
    ref = jq.sparse_canonical_projection(jnp.asarray(D), jnp.asarray(mask), q,
                                         num_hops=4, schedule=schedule)
    out = tq.sparse_canonical_projection(torch.as_tensor(D), torch.as_tensor(mask), q,
                                         num_hops=4, schedule=schedule)
    r, o = to_np(ref), to_np(out)
    assert np.array_equal(np.isinf(r), np.isinf(o))
    np.testing.assert_allclose(o[np.isfinite(r)], r[np.isfinite(r)], rtol=1e-5, atol=1e-5)


def test_log_domain_round_trip_and_infinities():
    D = torch.tensor([0.0, 0.5, 2.0, INF])
    L = tq.to_log_domain(D, 4.0)
    np.testing.assert_array_equal(to_np(L), to_np(jq.to_log_domain(jnp.asarray(to_np(D)), 4.0)))
    np.testing.assert_allclose(to_np(tq.from_log_domain(L, 4.0)), to_np(D), rtol=1e-6)


@pytest.mark.parametrize("q", QS)
def test_projection_is_q_metric_in_both(q):
    D = _dissimilarity(30, seed=4)
    Dq = tq.canonical_projection(torch.as_tensor(D), q)
    assert tq.is_q_metric(Dq, q)
    assert jq.is_q_metric(jnp.asarray(to_np(Dq)), q)


@pytest.mark.parametrize("q,violation", [(2.0, 0.98), (math.inf, 9.0)])
def test_q_violation_detects_what_the_jax_oracle_misses(q, violation):
    """Pins ROADMAP Queue 3: ``repro/core/qmetric.py:303`` bounds D[i, j] by
    min_z combine(D[i, z], D[i, j]) — with D[i, i] = 0 that is D[i, j]
    itself, so it reports 0 for any matrix.  The port's oracle combines
    D[i, z] with D[z, j] and sees the violation d(0, 2) = 10 > d(0,1), d(1,2)."""
    D = np.asarray([[0, 1, 10], [1, 0, 1], [10, 1, 0]], np.float32)
    assert float(jq.q_violation(jnp.asarray(D), q)) == 0.0
    assert float(tq.q_violation(torch.as_tensor(D), q)) == pytest.approx(violation)
    assert not tq.is_q_metric(torch.as_tensor(D), q)


@pytest.mark.parametrize("q", [2.0, math.inf])
def test_project_with_queries_matches_jax(q):
    """E_q of 12 queries over 40 points: the port's projection of D and its
    product of the query rows by D_q against JAX's (rtol 1e-5 / atol 2e-5,
    the projection's tolerance above); never above the direct distance."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(52, 6)).astype(np.float32)
    D = np.array(jmetrics.pairwise(jnp.asarray(X[:40]), jnp.asarray(X[:40])))
    np.fill_diagonal(D, 0.0)
    D = (D + D.T) / 2
    rows = np.array(jmetrics.pairwise(jnp.asarray(X[40:]), jnp.asarray(X[:40])))
    ref = jq.project_with_queries(jnp.asarray(D), jnp.asarray(rows), q, row_block=16)
    out = tq.project_with_queries(torch.as_tensor(D), torch.as_tensor(rows), q,
                                  row_block=16)
    np.testing.assert_allclose(to_np(out), to_np(ref), rtol=1e-5, atol=2e-5)
    assert (to_np(out) <= rows * (1 + 1e-6)).all()
