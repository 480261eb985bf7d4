"""The plain reference's exact top k against a NumPy brute force, and the
control's precision."""
import numpy as np
import torch

from bench.reference.exact import exact_topk, pair_dists, round_tf32


def _data(seed=0, n=700, m=37, d=48):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


def test_exact_topk_matches_numpy_brute_force():
    Q, X = _data()
    d, i = exact_topk(torch.tensor(Q), torch.tensor(X), k=10)
    D = np.sqrt(((Q[:, None, :].astype(np.float64) - X[None].astype(np.float64)) ** 2).sum(-1))
    want = np.argsort(D, axis=1, kind="stable")[:, :10]
    assert np.array_equal(i.numpy(), want)
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(D, want, 1), rtol=1e-12)


def test_exact_topk_skips_rows_that_are_not_alive():
    Q, X = _data(1)
    alive = np.ones(X.shape[0], bool)
    alive[::3] = False
    _, i = exact_topk(torch.tensor(Q), torch.tensor(X), k=10, alive=torch.tensor(alive))
    D = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    D[:, ~alive] = np.inf
    assert np.array_equal(i.numpy(), np.argsort(D, axis=1, kind="stable")[:, :10])


def test_pair_dists_are_the_float64_distances():
    Q, X = _data(2)
    qr, xr = np.array([0, 5, 36]), np.array([699, 0, 17])
    got = pair_dists(torch.tensor(Q), torch.tensor(X), torch.tensor(qr), torch.tensor(xr))
    want = np.sqrt(((Q[qr].astype(np.float64) - X[xr]) ** 2).sum(1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13, 3.0, -1.0 - 2 ** -12])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0, -1.0]


def test_the_control_reads_far_worse_than_float32():
    Q, X = _data(3, n=2000, m=64, d=784)
    Qt, Xt = torch.tensor(Q), torch.tensor(X)
    d64, i64 = exact_topk(Qt, Xt, k=10)
    dtf, itf = exact_topk(Qt, Xt, k=10, precision="tf32")
    d32 = torch.cdist(Qt, Xt).gather(1, i64).double()
    ref = d64.double()
    err32 = ((d32 - ref).abs() / ref).max()
    ref_tf = pair_dists(Qt, Xt, torch.arange(64).repeat_interleave(10), itf.reshape(-1)).reshape(64, 10)
    errtf = ((dtf.double() - ref_tf).abs() / ref_tf).max()
    assert errtf > 10 * err32
