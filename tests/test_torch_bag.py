"""Port parity: the embedding-bag module (``repro_torch.kernels.bag``)
against the JAX package's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and its jnp oracle, on the CPU.

Tolerance: atol 1e-5 on every output.  The three versions sum the same
f32 products in other orders (the port and the Pallas grid in ascending s,
the jnp oracle as an einsum), so they agree to a few ulps, not bit for bit.
A bf16 or f16 table is cast to f32 row by row (exactly) in the port and the
Pallas kernel, so the port's result on it equals its result on the f32 copy
of the table bit for bit.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.bag.bag import embedding_bag_pallas  # noqa: E402
from repro.kernels.bag.ref import embedding_bag_ref as jbag_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bag import ops  # noqa: E402
from repro_torch.kernels.bag.ref import embedding_bag_ref  # noqa: E402

ATOL = 1e-5


def _inputs(V, D, B, S, seed, weighted):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ids[3, 2:] = -1  # a partly padded row
    ids[7, :] = -1  # an all-padding row
    w = rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32) if weighted else None
    return table, ids, w


def _three(table, ids, w, combine):
    """(port, Pallas in interpret mode, jnp oracle) outputs as numpy."""
    tw = None if w is None else torch.as_tensor(w)
    jw = None if w is None else jnp.asarray(w)
    port = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids), tw,
                             combine=combine)
    pallas = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids), jw,
                                  combine=combine, interpret=True)
    oracle = jbag_ref(jnp.asarray(table), jnp.asarray(ids), jw, combine=combine)
    return port.numpy(), np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("D", [1, 10, 24])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_matches_pallas_and_oracle(D, combine, weighted):
    table, ids, w = _inputs(300, D, 10, 6, seed=D, weighted=weighted)
    port, pallas, oracle = _three(table, ids, w, combine)
    assert port.shape == (10, D) and port.dtype == np.float32
    np.testing.assert_allclose(port, pallas, atol=ATOL)
    np.testing.assert_allclose(port, oracle, atol=ATOL)
    # the all-padding row is exactly 0 under both combines
    assert (port[7] == 0.0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_takes_half_tables_as_jax_does(dtype, combine, weighted):
    """A bf16 / f16 table gives JAX's f32 result: the Pallas kernel casts
    each gathered row to f32 in-kernel.  The jnp oracle sums in the table's
    own dtype, so it is held on the f32 cast of the same table (its f32
    arithmetic); the port is also exactly its own result on that cast."""
    table, ids, w = _inputs(300, 10, 10, 6, seed=11, weighted=weighted)
    half = torch.as_tensor(table).to(getattr(torch, dtype))
    wide = half.float().numpy()  # the table's values, exactly, in f32
    tw = None if w is None else torch.as_tensor(w)
    jw = None if w is None else jnp.asarray(w)
    port = ops.embedding_bag(half, torch.as_tensor(ids), tw, combine=combine)
    assert port.dtype == torch.float32 and port.shape == (10, 10)
    jhalf = jnp.asarray(wide).astype(getattr(jnp, dtype))
    pallas = embedding_bag_pallas(jhalf, jnp.asarray(ids), jw, combine=combine,
                                  interpret=True)
    assert pallas.dtype == jnp.float32
    oracle = jbag_ref(jnp.asarray(wide), jnp.asarray(ids), jw, combine=combine)
    np.testing.assert_allclose(port.numpy(), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(port.numpy(), np.asarray(oracle), atol=ATOL)
    same = ops.embedding_bag(torch.as_tensor(wide), torch.as_tensor(ids), tw,
                             combine=combine)
    assert torch.equal(port, same)
    assert (port[7] == 0.0).all()


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_padding_reads_row_zero_with_weight_zero(combine):
    """A padding id still forms 0 * row 0: a non-finite row 0 gives NaN in
    the rows that hold padding, in the port as in both JAX versions."""
    table, ids, _ = _inputs(50, 4, 10, 6, seed=3, weighted=False)
    table[0] = np.inf
    ids[ids == 0] = 1  # row 0 is reached only through padding
    port, pallas, oracle = _three(table, ids, None, combine)
    for out in (port, pallas, oracle):
        assert np.isnan(out[3]).all() and np.isnan(out[7]).all()
    fin = np.isfinite(oracle)
    np.testing.assert_array_equal(np.isfinite(port), fin)
    np.testing.assert_allclose(port[fin], oracle[fin], atol=ATOL)


def test_bag_combines_in_ascending_s_order():
    """Each product and sum rounded on its own, in ascending s: the plain
    version is the kernel's arithmetic, checked here against a float32
    numpy loop in the same order."""
    table, ids, w = _inputs(200, 10, 16, 39, seed=8, weighted=True)
    out = embedding_bag_ref(torch.as_tensor(table), torch.as_tensor(ids),
                            torch.as_tensor(w), combine="mean").numpy()
    acc = np.zeros((16, 10), np.float32)
    wsum = np.zeros((16, 1), np.float32)
    for s in range(39):
        ws = (w[:, s] * (ids[:, s] >= 0)).astype(np.float32)[:, None]
        acc = acc + ws * table[np.maximum(ids[:, s], 0)]
        wsum = wsum + ws
    np.testing.assert_array_equal(out, acc / np.maximum(wsum, np.float32(1e-9)))


def test_bag_cpu_tensors_take_the_plain_version_and_int64_ids():
    table, ids, w = _inputs(100, 3, 10, 5, seed=9, weighted=True)
    before = _build.launches()
    out32 = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids),
                              torch.as_tensor(w))
    out64 = ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids).long(),
                              torch.as_tensor(w))
    assert _build.launches() == before
    assert torch.equal(out32, out64)


def test_bag_refuses_what_the_kernel_does_not_take():
    table = torch.zeros((10, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="f32, bf16 or f16 table"):
        ops.embedding_bag(table.to(torch.int32), ids)
    with pytest.raises(ValueError, match="combine"):
        ops.embedding_bag(table, ids, combine="max")
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(table, ids, torch.ones((2, 4)))


@settings(max_examples=10, deadline=None)
@given(
    b=st.integers(1, 12), s=st.integers(1, 9), v=st.integers(4, 200),
    d=st.integers(1, 33), seed=st.integers(0, 999),
)
def test_property_bag_sum(b, s, v, d, seed):
    """``tests/test_kernels.py::test_property_bag_sum``'s property, with the
    port beside the Pallas kernel and the oracle."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-1, v, size=(b, s)).astype(np.int32)
    port, pallas, oracle = _three(table, ids, None, "sum")
    np.testing.assert_allclose(port, pallas, atol=ATOL)
    np.testing.assert_allclose(port, oracle, atol=ATOL)
