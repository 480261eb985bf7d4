"""Port parity: the embedding bag's backward (``kernels/bag``:
``embedding_bag_backward_ref`` and ``BagFunction``) against ``jax.grad`` of
the bag written with ``jnp.take``, as the JAX package trains its tables
(``repro/dist/embedlookup.py``), on the CPU.

Cases: sum and mean, with and without weights, with padding ids (< 0: no
gradient) and an all-padding bag, and ids repeated within and across bags.
Tolerance rtol 1e-5 / atol 1e-7: the same products, summed in another
order (``index_add_`` against XLA's scatter-add).  ``gradcheck`` holds
the Function's backward to finite differences in f64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bag import ops  # noqa: E402
from repro_torch.kernels.bag.ref import bag_scale, embedding_bag_backward_ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7


def _jax_bag(table, ids, w, combine):
    """The bag as ``jnp.take`` and sums: padding reads row 0 with weight 0."""
    valid = (ids >= 0).astype(jnp.float32)
    eff = valid if w is None else w * valid
    rows = jnp.take(table, jnp.maximum(ids, 0), axis=0)  # (B, S, D)
    out = jnp.sum(eff[..., None] * rows, axis=1)
    if combine == "mean":
        out = out / jnp.maximum(jnp.sum(eff, axis=1, keepdims=True), 1e-9)
    return out


def _case(B, S, D, V, seed, pad=0.2):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ids[rng.random((B, S)) < pad] = -1
    ids[0] = -1  # an all-padding bag
    ids[1, :] = ids[2, 0] if ids[2, 0] >= 0 else 3  # one row many times
    w = rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32)
    g = rng.normal(size=(B, D)).astype(np.float32)
    return table, ids, w, g


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(16, 7, 1, 40), (33, 5, 10, 25), (8, 39, 4, 500)])
def test_plain_backward_matches_jax_grad(shape, combine, weighted):
    B, S, D, V = shape
    table, ids, w, g = _case(B, S, D, V, seed=sum(shape) + weighted)
    wj = jnp.asarray(w) if weighted else None
    _, vjp = jax.vjp(lambda t: _jax_bag(t, jnp.asarray(ids), wj, combine), jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    out = embedding_bag_backward_ref(torch.as_tensor(g), torch.as_tensor(ids),
                                     torch.as_tensor(w) if weighted else None, V,
                                     combine=combine)
    assert out.shape == (V, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # rows no valid id names get exactly 0
    named = np.zeros(V, bool)
    named[ids[ids >= 0]] = True
    assert (out.numpy()[~named] == 0).all()


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_autograd_through_the_bag_matches_jax_grad(combine, weighted):
    """``ops.embedding_bag`` on a table that requires grad runs
    ``BagFunction``: its forward is the plain bag and ``backward`` of a
    loss gives jax.grad's table gradient; no kernel launches on the CPU."""
    table, ids, w, g = _case(24, 9, 3, 60, seed=7 + weighted)
    wj = jnp.asarray(w) if weighted else None
    ref = jax.grad(lambda t: jnp.sum(_jax_bag(t, jnp.asarray(ids), wj, combine)
                                     * jnp.asarray(g)))(jnp.asarray(table))
    tt = torch.as_tensor(table).requires_grad_(True)
    before = _build.launches()
    out = ops.embedding_bag(tt, torch.as_tensor(ids),
                            torch.as_tensor(w) if weighted else None, combine=combine)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "BagFunctionBackward"
    (out * torch.as_tensor(g)).sum().backward()
    assert _build.launches() == before
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    fwd = _jax_bag(jnp.asarray(table), jnp.asarray(ids), wj, combine)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(fwd), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_gradcheck_in_f64(combine):
    table, ids, w, _ = _case(6, 4, 3, 12, seed=11, pad=0.25)
    t64 = torch.as_tensor(table, dtype=torch.float64).requires_grad_(True)
    idt, wt = torch.as_tensor(ids), torch.as_tensor(w, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda t: ops.embedding_bag(t, idt, wt, combine=combine), (t64,),
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_without_grad_the_bag_takes_no_function():
    table, ids, _, _ = _case(4, 3, 2, 10, seed=1)
    tt = torch.as_tensor(table).requires_grad_(True)
    with torch.no_grad():
        assert ops.embedding_bag(tt, torch.as_tensor(ids)).grad_fn is None
    assert ops.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids)).grad_fn is None


def test_what_the_backward_refuses():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    half = torch.zeros((10, 4), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="f32 table"):
        ops.embedding_bag(half, ids)
    w = torch.ones((2, 3), requires_grad=True)
    with pytest.raises(ValueError, match="weights"):
        ops.embedding_bag(torch.zeros((10, 4)), ids, w)
    with pytest.raises(ValueError, match="grad_out"):
        embedding_bag_backward_ref(torch.zeros((3, 4)), ids, None, 10)
    with pytest.raises(ValueError, match="combine"):
        embedding_bag_backward_ref(torch.zeros((2, 4)), ids, None, 10, combine="max")


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_integer_gradients_sum_exactly_in_any_order(combine):
    """Small integer weights and per-bag gradients (under ``mean`` an
    integer times the bag's weight sum) make every contribution an integer
    and every partial sum exact in f32, so the bags shuffled give the plain
    backward bit for bit: the card tests hold the atomics' sums so.  With
    normal gradients the two orders do round differently."""
    B, S, D, V = 4096, 39, 2, 50  # ~3 200 contributions a row
    rng = np.random.default_rng(3)
    _, ids, _, g = _case(B, S, D, V, seed=3)
    ids_t = torch.as_tensor(ids)
    w_t = torch.as_tensor(rng.integers(1, 4, size=(B, S)).astype(np.float32))
    k = torch.as_tensor(rng.integers(-4, 5, size=(B, D)).astype(np.float32))
    g_int = k * bag_scale(ids_t, w_t, combine)[1]
    perm = torch.as_tensor(rng.permutation(B))

    def both(grad):
        return (embedding_bag_backward_ref(grad, ids_t, w_t, V, combine=combine),
                embedding_bag_backward_ref(grad[perm], ids_t[perm], w_t[perm], V,
                                           combine=combine))

    ref, other = both(g_int)
    assert torch.equal(ref, other)
    exact = torch.zeros((V, D), dtype=torch.float64).index_add_(
        0, ids_t[ids_t >= 0].long(),
        (w_t[:, :, None].double() * k[:, None, :].double())[ids_t >= 0])
    assert torch.equal(ref.double(), exact)
    ref, other = both(torch.as_tensor(g))
    assert bool((other != ref).any())
