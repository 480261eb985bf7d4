"""Helpers shared by the ``test_torch_*`` parity tests: numpy views of JAX
arrays and torch tensors, and the id comparison with its near-tie rule."""
import numpy as np

#: matmul-family distance tolerance (tests/test_kernels.py:50 for atol)
RTOL, ATOL = 1e-5, 5e-4


def to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(a, b, *, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


def assert_same_ids(ids, dists, ref_ids, ref_dists, *, rtol=RTOL, atol=ATOL):
    """Ids identical to the reference's, except on near ties.

    Distances must agree within tolerance everywhere.  Where the ids
    differ, the reference must hold a near tie at that rank: its distance
    is within tolerance of the rank above or below, or the rank is the
    last one (whose tie partner, the (k+1)-th, is not returned)."""
    ids, ref_ids = to_np(ids), to_np(ref_ids)
    d, rd = to_np(dists), to_np(ref_dists)
    np.testing.assert_allclose(d, rd, rtol=rtol, atol=atol)
    mism = ids != ref_ids
    if not mism.any():
        return
    tol = atol + rtol * np.abs(rd)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(rd, axis=1)) <= tol[:, :-1]
    near = np.zeros_like(mism)
    near[:, :-1] |= gap
    near[:, 1:] |= gap
    near[:, -1] = True
    bad = mism & ~near
    assert not bad.any(), (
        f"{int(bad.sum())} id mismatches off any near tie, e.g. row "
        f"{np.argwhere(bad)[0].tolist()}"
    )
