"""Port parity: ``repro_torch.core.metrics`` and the pdist kernel module
against ``repro.core.metrics``, ``repro.kernels.pdist.ref`` and the Pallas
kernel in interpret mode, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jmetrics  # noqa: E402
from repro.kernels.pdist.pdist import pdist_pallas  # noqa: E402
from repro.kernels.pdist.ref import pdist_ref as jpdist_ref  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.pdist import ops as pdist_ops  # noqa: E402
from repro_torch.kernels.pdist.ref import pdist_ref  # noqa: E402
from torch_parity import assert_close, to_np  # noqa: E402

METRICS = list(jmetrics.METRICS)
PDIST_SHAPES = [(40, 56, 20), (128, 128, 64), (33, 257, 100)]  # tests/test_kernels.py
PDIST_METRICS = ["sqeuclidean", "euclidean", "cosine", "dot", "manhattan", "chebyshev"]


def _data(m, n, d, metric, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    if metric == "jaccard":
        X, Y = (X > 0.3).astype(np.float32), (Y > 0.3).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("metric", METRICS)
def test_matrix_forms_match_jax(metric):
    X, Y = _data(20, 30, 8, metric)
    ref = jmetrics.matrix_fn(metric)(jnp.asarray(X), jnp.asarray(Y))
    out = tmetrics.matrix_fn(metric)(torch.as_tensor(X), torch.as_tensor(Y))
    assert_close(out, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_pair_forms_match_jax_batched(metric):
    X, Y = _data(12, 12, 8, metric, seed=1)
    ref = jax.vmap(jmetrics.pair_fn(metric))(jnp.asarray(X), jnp.asarray(Y))
    out = tmetrics.pair_fn(metric)(torch.as_tensor(X), torch.as_tensor(Y))
    assert out.shape == (12,)
    assert_close(out, ref)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("block", [0, 7])
def test_pairwise_matches_jax(metric, block):
    X, Y = _data(25, 19, 6, metric, seed=2)
    ref = jmetrics.pairwise(jnp.asarray(X), jnp.asarray(Y), metric=metric, block=block)
    out = tmetrics.pairwise(torch.as_tensor(X), torch.as_tensor(Y), metric=metric,
                            block=block)
    assert out.shape == (25, 19)
    assert_close(out, ref)


@pytest.mark.parametrize("shape", PDIST_SHAPES)
@pytest.mark.parametrize("metric", PDIST_METRICS)
def test_pdist_plain_matches_jax_ref_and_pallas(shape, metric):
    m, n, d = shape
    rng = np.random.default_rng([*shape, PDIST_METRICS.index(metric)])
    X = rng.normal(size=(m, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    out = pdist_ref(torch.as_tensor(X), torch.as_tensor(Y), metric=metric)
    assert_close(out, jpdist_ref(jnp.asarray(X), jnp.asarray(Y), metric=metric))
    assert_close(out, pdist_pallas(jnp.asarray(X), jnp.asarray(Y), metric=metric,
                                   interpret=True))


@pytest.mark.parametrize("metric", ["manhattan", "chebyshev"])
def test_pdist_plain_cube_row_blocks_match_pallas(monkeypatch, metric):
    """With the intermediate bound forcing ragged row blocks (5 rows of 37),
    the plain cube matrix still matches the JAX ``_cube_kernel`` (interpret
    mode); chebyshev exactly."""
    from repro_torch.kernels.pdist import ref as ref_mod

    rng = np.random.default_rng(21)
    X = rng.normal(size=(37, 45)).astype(np.float32)
    Y = rng.normal(size=(70, 45)).astype(np.float32)
    monkeypatch.setattr(ref_mod, "CUBE_BLOCK_BYTES", 4 * 70 * 45 * 5)
    out = pdist_ref(torch.as_tensor(X), torch.as_tensor(Y), metric=metric)
    ref = pdist_pallas(jnp.asarray(X), jnp.asarray(Y), metric=metric, interpret=True)
    assert out.shape == (37, 70)
    if metric == "chebyshev":
        np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    else:
        assert_close(out, ref)


def test_pdist_ops_cpu_tensors_take_the_plain_version():
    X = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    before = _build.launches()
    out = pdist_ops.pdist(X, X, metric="euclidean")
    assert _build.launches() == before
    assert torch.equal(out, pdist_ref(X, X, metric="euclidean"))


def test_pairwise_is_symmetric_with_zero_diagonal_on_self():
    X, _ = _data(16, 1, 5, "euclidean", seed=3)
    D = tmetrics.pairwise(torch.as_tensor(X), torch.as_tensor(X))
    assert_close(D, D.T)
    assert float(D.diagonal().abs().max()) < 1e-3


def test_unknown_metric_raises():
    with pytest.raises(KeyError):
        tmetrics.matrix_fn("hamming")
