"""Port parity: ``core/baselines`` (``brute_force`` and ``BruteIndex``, f32
and int8) against the JAX package's brute engine built with
``impl="pallas"`` (its topk kernels in interpret mode), on the CPU.

Tolerances: f32 distances rtol 1e-5 / atol 5e-4 (the matmul family's);
the int8 first pass is held to JAX's own kernel function, so the final
ids and exact f32 distances match JAX's except on near ties
(``torch_parity.assert_same_ids``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import index as jindex  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import chaos as tchaos  # noqa: E402
from repro_torch.core import index as tindex  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from torch_parity import assert_same_ids, to_np  # noqa: E402

CPU = "cpu"
N, D = 512, 24


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Q = rng.normal(size=(16, D)).astype(np.float32)
    return X, Q


def _recall(a, b, k):
    a, b = to_np(a), to_np(b)
    return float(np.mean([len(set(x[:k]) & set(y[:k])) / k for x, y in zip(a, b)]))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "manhattan", "chebyshev"])
def test_brute_f32_matches_jax_pallas(data, metric):
    X, Q = data
    jr = jindex.build("brute", X, {"impl": "pallas", "metric": metric}).search(Q, k=10)
    eng = tindex.build("brute", X, {"metric": metric}, device=CPU)
    before = _build.launches()
    tr = eng.search(Q, k=10)
    assert _build.launches() == before  # CPU tensors take the plain version
    assert tr.idx.dtype == torch.int32 and tr.comparisons.dtype == torch.int32
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    assert (to_np(tr.comparisons) == N).all()


@pytest.mark.parametrize("k", [1, 10, 40])
def test_brute_int8_matches_jax_pallas(data, k):
    """The quantized two-stage: int8 first pass (JAX's Pallas int8 kernel in
    interpret mode on one side, the port's plain version of its kernel on
    the other), exact f32 rerank, comparisons n + K."""
    X, Q = data
    jeng = jindex.build("brute", X, {"impl": "pallas", "quant": True})
    jr = jeng.search(Q, k=k)
    eng = tindex.build("brute", X, {"quant": True}, device=CPU)
    tr = eng.search(Q, k=k)
    np.testing.assert_array_equal(eng.quant.codes, jeng.quant.codes)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    K = tquant.shortlist_width(k, N)
    assert (to_np(tr.comparisons) == N + K).all()
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))
    # the returned distances are exact original-metric values
    ref = np.linalg.norm(Q[:, None] - X[to_np(tr.idx)], axis=-1)
    np.testing.assert_allclose(to_np(tr.dist), ref, rtol=1e-4, atol=1e-4)


def test_brute_int8_recall_and_bytes(data):
    """``tests/test_quant.py``'s acceptance bar, in the port: recall@10 >=
    0.99 against the f32 scan at a quarter of the scanned bytes, and the
    memory audit JAX reports."""
    X, Q = data
    gt = tindex.build("brute", X, {}, device=CPU).search(Q, k=10)
    eng = tindex.build("brute", X, {"quant": True}, device=CPU)
    res = eng.search(Q, k=10)
    assert _recall(res.idx, gt.idx, 10) >= 0.99
    assert eng.quant.codes.nbytes * 4 == X.nbytes
    jeng = jindex.build("brute", X, {"quant": True})
    assert eng.memory_bytes() == jeng.memory_bytes()
    assert eng.memory_bytes() == X.nbytes + eng.quant.memory_bytes()


def test_brute_force_function_matches_jax(data):
    from repro.core import baselines as jbase

    X, Q = data
    jr = jbase.brute_force(jnp.asarray(X), jnp.asarray(Q), k=7, impl="pallas", block=128)
    tr = tbase.brute_force(torch.as_tensor(X), torch.as_tensor(Q), k=7, block=128)
    assert_same_ids(tr.idx, tr.dist, jr.idx, jr.dist)
    np.testing.assert_array_equal(to_np(tr.comparisons), np.asarray(jr.comparisons))


def test_brute_snapshot_crosses_from_jax(data):
    X, Q = data
    jeng = jindex.build("brute", X, {"impl": "pallas", "metric": "sqeuclidean",
                                     "budget": 5})
    arrays, statics = jeng.snapshot_state()
    eng = convert.brute_from_jax_state(jax.tree_util.tree_map(np.asarray, arrays),
                                       statics, device=CPU)
    assert (eng.metric, eng.impl, eng.search_defaults) == ("sqeuclidean", "pallas",
                                                          {"budget": 5})
    assert_same_ids(eng.search(Q, k=5).idx, eng.search(Q, k=5).dist,
                    jeng.search(Q, k=5).idx, jeng.search(Q, k=5).dist)
    tarr, tstat = eng.snapshot_state()
    assert tstat == statics
    np.testing.assert_array_equal(to_np(tarr["X"]), X)
    # a JAX store carried across gives the port JAX's codes
    jstore = jquant.QuantStore.build(X)
    tindex.attach_quant_store(eng, convert.quant_store_from_jax(
        jstore.snapshot_state()[0], device=CPU))
    np.testing.assert_array_equal(eng.quant.codes, jstore.codes)


def test_brute_registry_keys(data):
    X, Q = data
    eng = tindex.build("brute", X, {"metric": "manhattan", "block": 64, "budget": 9},
                       device=CPU)
    assert (eng.metric, eng.block, eng.search_defaults) == ("manhattan", 64, {"budget": 9})
    assert eng.X.device.type == "cpu"
    with pytest.raises(TypeError, match="unknown cfg keys"):
        tindex.build("brute", X, {"nprobe": 3}, device=CPU)
    # the chaos key arms a fault plan: a build-site rule poisons the build
    with pytest.raises(tchaos.BuildFault):
        tindex.build("brute", X, {"chaos": {"rules": [{"site": "build", "rate": 1.0}]}},
                     device=CPU)
    # the attrs key builds a store, and a filter restricts the answers
    eng = tindex.build("brute", X, {"attrs": {"score": np.arange(N)}}, device=CPU)
    res = eng.search(Q, k=3, filter={"score": {"range": [None, 9]}})
    assert (to_np(res.idx) < 10).all() and (to_np(res.comparisons) == 10).all()


def test_brute_defaults_to_cuda(monkeypatch, data):
    X, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tindex.build("brute", X, {})
