"""Port parity at wide k: the plain topk versions (f32 matmul and cube
families, int8 codes) and the brute engine at k = 600 and at k > n against
the JAX package's ``brute_force`` / ``topk_scan`` / ``topk_scan_quant``,
on the CPU.  The CUDA kernels take any k >= 1 as well (card tests in
``test_torch_cuda.py``); JAX's take any k.

Tolerances: f32 distances rtol 1e-5 / atol 5e-4 (the matmul family's),
int8 distances rtol / atol 1e-4 (``tests/test_quant.py:108-110``); ids
identical except on near ties (``torch_parity.assert_same_ids``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import scan as jscan  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core import scan as tscan  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

QTOL = dict(rtol=1e-4, atol=1e-4)
N, D = 900, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(9, D)).astype(np.float32))


def _past_n(idx, dist, n):
    """Slots past the n candidates hold (+inf, -1)."""
    assert (to_np(idx)[:, n:] == -1).all()
    assert np.isinf(to_np(dist)[:, n:]).all()


@pytest.mark.parametrize("k", [600, 1000])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan", "chebyshev"])
def test_brute_force_wide_k_matches_jax(data, k, metric):
    X, Q = data
    before = _build.launches()
    out = tbase.brute_force(torch.as_tensor(X), torch.as_tensor(Q), k=k, metric=metric)
    assert _build.launches() == before  # CPU tensors take the plain version
    ref = jbase.brute_force(jnp.asarray(X), jnp.asarray(Q), k=k, metric=metric)
    assert out.idx.shape == (9, k)
    assert_same_ids(out.idx, out.dist, ref.idx, ref.dist)
    if k > N:
        _past_n(out.idx, out.dist, N)


@pytest.mark.parametrize("k", [600, 1000])
def test_topk_scan_wide_k_with_mask_and_self_exclusion(data, k):
    X, _ = data
    valid = np.arange(N) % 4 != 1
    out = tscan.topk_scan(torch.as_tensor(X[:40]), torch.as_tensor(X), k=k,
                          exclude_self=True, valid=torch.as_tensor(valid))
    ref = jscan.topk_scan(jnp.asarray(X[:40]), jnp.asarray(X), k=k,
                          exclude_self=True, valid=jnp.asarray(valid))
    assert_same_ids(out[1], out[0], ref[1], ref[0])
    # 675 valid columns, one of them the row itself for rows 0, 2, 3, ...
    assert (to_np(out[1])[:, 675:] == -1).all()


def _quant_pair(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    Q = rng.normal(size=(2, D)).astype(np.float32)
    return X, Q, jquant.QuantStore.build(X), tquant.QuantStore.build(torch.as_tensor(X))


@pytest.mark.parametrize("n,k,metric", [(610, 600, "euclidean"), (140, 150, "sqeuclidean")])
def test_topk_scan_quant_wide_k_matches_jax_pallas(n, k, metric):
    """The int8 kernel's function (JAX's ``impl="pallas"``, its kernel in
    interpret mode) at wide k.  Past n the port holds (+inf, -1); JAX's
    kernel holds +inf with stale ids there (see the next test), so ids are
    compared over the n real candidates."""
    X, Q, js, ts = _quant_pair(n, seed=n)
    codes, scales, sqn = ts.device_view()
    out = tscan.topk_scan_quant(torch.as_tensor(Q), codes, scales, k=k,
                                metric=metric, sqnorms=sqn)
    jc, jsc, jsq = js.device_view()
    ref = jscan.topk_scan_quant(jnp.asarray(Q), jc, jsc, k=k, metric=metric,
                                impl="pallas", sqnorms=jsq)
    live = min(n, k)
    assert_same_ids(out[1][:, :live], out[0][:, :live], np.asarray(ref[1])[:, :live],
                    np.asarray(ref[0])[:, :live], **QTOL)
    assert out[1].shape == (2, k)
    if k > n:
        _past_n(out[1], out[0], n)
        assert np.isinf(np.asarray(ref[0])[:, n:]).all()


def test_jax_pallas_topk_leaves_stale_ids_past_n():
    """Pins a fault of the reference (ROADMAP Queue 3): with k > n and n
    over more than one column tile, JAX's Pallas topk kernels (f32 and
    int8, interpret mode) fill the slots past n with +inf and ids of real
    candidates instead of -1; the jnp scan and the port give -1."""
    from repro.kernels.topk.topk import topk_pallas

    X, Q, js, ts = _quant_pair(140, seed=3)
    _, pi = topk_pallas(jnp.asarray(Q), jnp.asarray(X), k=150, metric="euclidean",
                        interpret=True)
    jc, jsc, jsq = js.device_view()
    _, qi = jscan.topk_scan_quant(jnp.asarray(Q), jc, jsc, k=150, impl="pallas",
                                  sqnorms=jsq)
    for ids in (np.asarray(pi), np.asarray(qi)):
        assert (ids[:, 140:] >= 0).any()
    _, ji = jscan.topk_scan(jnp.asarray(Q), jnp.asarray(X), k=150)
    assert (np.asarray(ji)[:, 140:] == -1).all()
    td, ti = tscan.topk_scan(torch.as_tensor(Q), torch.as_tensor(X), k=150)
    _past_n(ti, td, 140)
