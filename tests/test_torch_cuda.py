"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device: the ``cuda`` fixture decides, and
skips without one (never at import, so every xdist worker collects the same
tests).  Run on a card with ``pytest -m gpu tests/test_torch_cuda.py``.
Tolerances: matmul-family and manhattan distances rtol 1e-5 / atol 5e-4
(the JAX kernel tests' atol; manhattan sums d terms in another order);
chebyshev bit-identical (a max of exact differences); the int8 kernel
bit-identical, distances and ids (its int32 cross term is exact and its
epilogue rounds as the plain version does); f32 ids identical except on
near ties; minmax and minplus bit-identical; logminplus atol 1e-5; the
embedding bag bit-identical (``torch.equal``: the kernel and its plain
version round the same products and sums in the same order); recsys
logits against the CPU rtol / atol 1e-5.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import index as index_lib  # noqa: E402
from repro_torch.core import qmetric  # noqa: E402
from repro_torch.core import quant as quant_lib  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bag import bag as bag_mod  # noqa: E402
from repro_torch.kernels.bag.bag import embedding_bag_cuda  # noqa: E402
from repro_torch.kernels.bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.pdist.pdist import pdist_cuda  # noqa: E402
from repro_torch.kernels.pdist.ref import pdist_ref  # noqa: E402
from repro_torch.kernels.qpath.qpath import qpath_matmul_cuda  # noqa: E402
from repro_torch.kernels.qpath.ref import qpath_matmul_ref  # noqa: E402
from repro_torch.kernels.topk.ref import topk_quant_ref, topk_ref  # noqa: E402
from repro_torch.kernels.topk import topk as topk_mod  # noqa: E402
from repro_torch.kernels.topk.topk import (  # noqa: E402
    int8_plan, split_plan, topk_cuda, topk_quant_cuda,
)
from torch_parity import assert_same_ids  # noqa: E402

pytestmark = pytest.mark.gpu

MATMUL = ["sqeuclidean", "euclidean", "cosine", "dot"]
CUBE = ["manhattan", "chebyshev"]
# (m, k, n): ragged tiles, k not a multiple of 4 (the 4-byte copies), k
# shorter than one 32-deep stage, and a 16-byte-copy shape whose k ends
# inside a stage
QPATH_SHAPES = [(32, 48, 16), (128, 128, 128), (130, 70, 257), (8, 300, 9), (70, 7, 130),
                (129, 20, 65), (128, 36, 128)]
MODES = ["minplus", "minmax", "logminplus"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)


def test_build_reports_every_kernel(cuda):
    info = _build.build()
    for name in ("pdist_kernel", "topk_kernel", "topk_int8_kernel", "qpath_kernel",
                 "min_splits_kernel", "bag_kernel", "bag_warp_kernel", "bag_backward_kernel",
                 "merge_kernel",
                 "sqnorm_kernel"):
        assert name in info["ptxas"]


# (m, n, d): ragged tiles, d % 4 != 0 (the 4-byte copies: d = 101, 3)
@pytest.mark.parametrize("shape", [(40, 56, 20), (128, 128, 64), (33, 257, 100),
                                   (130, 70, 101), (65, 129, 3), (2048, 2048, 784)])
@pytest.mark.parametrize("metric", MATMUL)
def test_pdist_kernel_matches_plain(cuda, shape, metric):
    m, n, d = shape
    X, Y = _normal((m, d), 1, cuda), _normal((n, d), 2, cuda)
    before = _build.launches()["pdist/matmul"]
    out = pdist_cuda(X, Y, metric=metric)
    torch.cuda.synchronize()
    assert _build.launches()["pdist/matmul"] == before + 1
    ref = pdist_ref(X, Y, metric=metric)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("shape", [(40, 56, 20), (33, 257, 100), (130, 70, 101), (65, 129, 3),
                                   (2048, 2048, 784)])
@pytest.mark.parametrize("metric", CUBE)
def test_pdist_cube_kernel_matches_plain(cuda, shape, metric):
    m, n, d = shape
    X, Y = _normal((m, d), 1, cuda), _normal((n, d), 2, cuda)
    before = _build.launches()["pdist/cube"]
    out = pdist_cuda(X, Y, metric=metric)
    torch.cuda.synchronize()
    assert _build.launches()["pdist/cube"] == before + 1
    ref = pdist_ref(X, Y, metric=metric)
    if metric == "chebyshev":
        assert torch.equal(out, ref)
    else:
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-5, atol=5e-4)


@pytest.mark.parametrize("metric", MATMUL)
def test_topk_kernel_all_metrics(cuda, metric):
    X, Y = _normal((40, 24), 1, cuda), _normal((300, 24), 2, cuda)
    od, oi = topk_cuda(X, Y, k=10, metric=metric)
    rd, ri = topk_ref(X, Y, k=10, metric=metric)
    assert_same_ids(oi, od, ri, rd)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (33, 257, 20, 5), (130, 129, 7, 17),
                                   (8, 4096, 128, 64), (70, 500, 16, 128)])
def test_topk_kernel_ragged_shapes(cuda, shape):
    m, n, d, k = shape
    X, Y = _normal((m, d), 3, cuda), _normal((n, d), 4, cuda)
    od, oi = topk_cuda(X, Y, k=k, metric="sqeuclidean")
    rd, ri = topk_ref(X, Y, k=k, metric="sqeuclidean")
    assert_same_ids(oi, od, ri, rd)


def test_topk_kernel_k_exceeds_n(cuda):
    X, Y = _normal((6, 4), 5, cuda), _normal((10, 4), 6, cuda)
    d, i = topk_cuda(X, Y, k=25, metric="euclidean")
    rd, ri = topk_ref(X, Y, k=25, metric="euclidean")
    assert torch.isinf(d[:, 10:]).all() and (i[:, 10:] == -1).all()
    assert torch.equal(i.cpu(), ri.cpu())


def test_topk_kernel_ties_pick_lowest_index(cuda):
    base = np.random.default_rng(4).normal(size=(20, 8)).astype(np.float32)
    Y = torch.as_tensor(np.concatenate([base] * 3), device=cuda)
    X = torch.as_tensor(base[:7], device=cuda)
    d, i = topk_cuda(X, Y, k=9, metric="sqeuclidean")
    rd, ri = topk_ref(X, Y, k=9, metric="sqeuclidean")
    # exact duplicates tie exactly in both: the lowest copy comes first
    assert (i[:, :3].cpu().numpy() == np.arange(7)[:, None] + np.array([0, 20, 40])).all()
    assert torch.equal(i[:, :3].cpu(), ri[:, :3].cpu())


def test_topk_kernel_exclude_self_and_valid(cuda):
    X = _normal((64, 8), 7, cuda)
    valid = torch.as_tensor(np.arange(64) % 3 != 0, device=cuda)
    od, oi = topk_cuda(X, X, k=5, metric="euclidean", exclude_self=True, valid=valid)
    rd, ri = topk_ref(X, X, k=5, metric="euclidean", exclude_self=True, valid=valid)
    assert_same_ids(oi, od, ri, rd)
    ids = oi.cpu().numpy()
    assert not np.isin(ids, np.arange(0, 64, 3)).any()
    assert (ids != np.arange(64)[:, None]).all()
    d, i = topk_cuda(X[:5], X[:5], k=5, metric="sqeuclidean", exclude_self=True)
    assert (i[:, -1] == -1).all() and torch.isinf(d[:, -1]).all()


def _plan(m, n, k, metric, dev):
    return split_plan(m, n, k, topk_mod._slots(metric, k, dev))


def _split_case(case, dev):
    """(X, Y, k, exclude_self, valid, metric) of one split-design case."""
    rng = np.random.default_rng(SPLIT_CASES.index(case))
    normal = (lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=dev))
    if case == "ties across a boundary":
        Y = normal(2048, 32)
        Y = torch.cat([Y, Y])  # row j and j + 2048 lie in different splits
        return Y[:64].clone(), Y, 10, False, None, "sqeuclidean"
    if case == "a split masked":
        Y = normal(4096, 24)
        a, b = _plan(40, 4096, 10, "euclidean", dev)[1]
        valid = torch.ones(4096, dtype=torch.bool, device=dev)
        valid[a:b] = False
        return normal(40, 24), Y, 10, False, valid, "euclidean"
    if case == "k over one split":
        return normal(40, 16), normal(4096, 16), 200, False, None, "euclidean"
    if case == "k over n":
        return normal(9, 16), normal(1000, 16), 1500, False, None, "euclidean"
    if case == "exclude_self at boundaries":
        X = normal(2048, 40)
        return X, X, 16, True, None, "euclidean"
    if case == "ragged strips":
        return normal(100, 36), normal(5000, 36), 10, False, None, "euclidean"
    if case == "ragged strips, 32-row":
        return normal(33, 20), normal(5000, 20), 100, False, None, "cosine"
    if case == "k = 600":
        return normal(512, 64), normal(20000, 64), 600, False, None, "euclidean"
    if case == "unaligned d":
        return normal(70, 13), normal(3000, 13), 10, False, None, "dot"
    raise KeyError(case)


SPLIT_CASES = ["ties across a boundary", "a split masked", "k over one split", "k over n",
               "exclude_self at boundaries", "ragged strips", "ragged strips, 32-row",
               "k = 600", "unaligned d"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_topk_kernel_splits(cuda, case):
    """The scan over S > 1 column ranges and the merge of their lists
    against the plain version: one counted launch, (distance, column)
    order across splits, (+inf, -1) past the valid candidates."""
    X, Y, k, excl, valid, metric = _split_case(case, cuda)
    m, n = X.shape[0], Y.shape[0]
    plan = _plan(m, n, k, metric, cuda)
    assert len(plan) > 1, plan
    before = _build.launches()["topk/f32"]
    od, oi = topk_cuda(X, Y, k=k, metric=metric, exclude_self=excl, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()["topk/f32"] == before + 1
    rd, ri = topk_ref(X, Y, k=k, metric=metric, exclude_self=excl, valid=valid)
    assert_same_ids(oi, od, ri, rd)
    live = n if valid is None else int(valid.sum())
    live -= 1 if excl else 0
    if k > live:
        assert torch.isinf(od[:, live:]).all() and (oi[:, live:] == -1).all()
    if case == "ties across a boundary":
        # exact duplicates tie exactly: the lower copy first, in both
        want = np.arange(64)[:, None] + np.array([0, 2048])
        assert (oi[:, :2].cpu().numpy() == want).all()
        assert torch.equal(oi[:, :2].cpu(), ri[:, :2].cpu())
    if case == "a split masked":
        a, b = plan[1]
        assert not ((oi >= a) & (oi < b)).any()
    if case == "exclude_self at boundaries":
        rows = torch.tensor([a for a, _ in plan[1:]] + [b - 1 for _, b in plan],
                            device=cuda)
        assert not (oi[rows] == rows[:, None]).any()


WIDE_K = [512, 513, 600, 2048]


@pytest.mark.parametrize("k", WIDE_K + [3500])
@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "chebyshev"])
def test_topk_kernel_wide_k(cuda, metric, k):
    """Any k >= 1: up to 512 the running lists sit in shared memory, above
    it in the output buffers; k = 3500 exceeds n, whose slots past n hold
    (+inf, -1)."""
    X, Y = _normal((40, 16), 8, cuda), _normal((3000, 16), 9, cuda)
    valid = torch.as_tensor(np.arange(3000) % 11 != 4, device=cuda)
    counter = "topk/f32" if metric == "euclidean" else "topk/cube"
    before = _build.launches()[counter]
    od, oi = topk_cuda(X, Y, k=k, metric=metric, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()[counter] == before + 1
    rd, ri = topk_ref(X, Y, k=k, metric=metric, valid=valid)
    if metric == "chebyshev":
        assert torch.equal(od, rd) and torch.equal(oi, ri)
    else:
        assert_same_ids(oi, od, ri, rd)
    live = int(valid.sum())
    if k > live:
        assert torch.isinf(od[:, live:]).all() and (oi[:, live:] == -1).all()


@pytest.mark.parametrize("k", WIDE_K + [2500])
def test_topk_int8_kernel_wide_k(cuda, k):
    store, Q = _store(2000, 20, 31, cuda)
    codes, scales, sqn = store.device_view()
    od, oi = topk_quant_cuda(Q, codes, scales, sqn, k=k, metric="euclidean")
    rd, ri = topk_quant_ref(Q, codes, scales, sqn, k=k, metric="euclidean")
    assert torch.equal(od, rd) and torch.equal(oi, ri)
    if k > 2000:
        assert torch.isinf(od[:, 2000:]).all() and (oi[:, 2000:] == -1).all()


def test_topk_kernel_k_below_one_raises_and_brute_takes_wide_k(cuda):
    X, Y = _normal((4, 8), 1, cuda), _normal((50, 8), 2, cuda)
    with pytest.raises(ValueError, match="k >= 1"):
        topk_cuda(X, Y, k=0)
    # brute_force(X, Q, k=600) answers on the card as in JAX
    from repro_torch.core.baselines import brute_force

    C, Qs = _normal((5000, 32), 3, cuda), _normal((64, 32), 4, cuda)
    res = brute_force(C, Qs, k=600)
    torch.cuda.synchronize()
    rd, ri = topk_ref(Qs, C, k=600, metric="euclidean")
    assert res.idx.shape == (64, 600)
    assert_same_ids(res.idx, res.dist, ri, rd)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (33, 257, 20, 5), (130, 129, 7, 17),
                                   (70, 500, 16, 128), (2048, 2048, 784, 16)])
@pytest.mark.parametrize("metric", CUBE)
def test_topk_cube_kernel_matches_plain(cuda, shape, metric):
    m, n, d, k = shape
    X = _normal((m, d), 10, cuda)
    Y = X if m == n else _normal((n, d), 11, cuda)
    excl = m == n
    valid = torch.as_tensor(np.arange(n) % 5 != 2, device=cuda) if n > 1 else None
    before = _build.launches()["topk/cube"]
    od, oi = topk_cuda(X, Y, k=k, metric=metric, exclude_self=excl, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()["topk/cube"] == before + 1
    rd, ri = topk_ref(X, Y, k=k, metric=metric, exclude_self=excl, valid=valid)
    if metric == "chebyshev":
        # exact distances, so exact ties break by the lowest column in both
        assert torch.equal(od, rd) and torch.equal(oi, ri)
    else:
        assert_same_ids(oi, od, ri, rd)


def test_topk_cube_kernel_ties_pick_lowest_index(cuda):
    base = np.random.default_rng(12).normal(size=(20, 8)).astype(np.float32)
    Y = torch.as_tensor(np.concatenate([base] * 3), device=cuda)
    X = torch.as_tensor(base[:7], device=cuda)
    for metric in CUBE:
        d, i = topk_cuda(X, Y, k=9, metric=metric)
        rd, ri = topk_ref(X, Y, k=9, metric=metric)
        assert (i[:, :3].cpu().numpy() == np.arange(7)[:, None] + np.array([0, 20, 40])).all()
        assert torch.equal(i[:, :3].cpu(), ri[:, :3].cpu())


def _store(n, d, seed, dev):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=dev)
    Q = torch.as_tensor(rng.normal(size=(37, d)).astype(np.float32), device=dev)
    return quant_lib.QuantStore.build(X), Q


@pytest.mark.parametrize("shape", [(1, 1, 1), (257, 20, 5), (300, 21, 64), (4096, 128, 256),
                                   (60000, 784, 64)])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_topk_int8_kernel_matches_plain(cuda, shape, metric):
    """d not a multiple of 4 takes the byte-assembled loads; the plain
    version's float64 cross term is exact, like the kernel's int32 one."""
    n, d, k = shape
    store, Q = _store(n, d, n + d, cuda)
    codes, scales, sqn = store.device_view()
    valid = torch.as_tensor(np.arange(n) % 7 != 3, device=cuda) if n > 1 else None
    before = _build.launches()["topk/int8"]
    od, oi = topk_quant_cuda(Q, codes, scales, sqn, k=k, metric=metric, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()["topk/int8"] == before + 1
    rd, ri = topk_quant_ref(Q, codes, scales, sqn, k=k, metric=metric, valid=valid)
    assert torch.equal(od, rd) and torch.equal(oi, ri)


def _int8_split_case(case, dev):
    """(store, Q, k, valid) of one int8 split-design case."""
    rng = np.random.default_rng(INT8_SPLIT_CASES.index(case))
    normal = (lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32), device=dev))
    if case == "ties across a boundary":
        X = normal(2048, 32)
        X = torch.cat([X, X])  # equal codes 2048 columns apart, in different splits
        return quant_lib.QuantStore.build(X), X[:64].clone(), 10, None
    if case == "a split masked":
        a, b = int8_plan(40, 4096, 10, dev)[1]
        valid = torch.ones(4096, dtype=torch.bool, device=dev)
        valid[a:b] = False
        return quant_lib.QuantStore.build(normal(4096, 24)), normal(40, 24), 10, valid
    if case == "k over one split":
        return quant_lib.QuantStore.build(normal(4096, 16)), normal(40, 16), 200, None
    if case == "k over n":
        return quant_lib.QuantStore.build(normal(1000, 16)), normal(9, 16), 1500, None
    if case == "ragged strips":
        return quant_lib.QuantStore.build(normal(5000, 36)), normal(200, 36), 10, None
    if case in ("unaligned d = 13", "unaligned d = 21"):
        d = int(case.rsplit(" ", 1)[1])
        valid = torch.as_tensor(np.arange(3000) % 7 != 3, device=dev)
        return quant_lib.QuantStore.build(normal(3000, d)), normal(70, d), 10, valid
    if case == "k = 600":
        return quant_lib.QuantStore.build(normal(20000, 64)), normal(512, 64), 600, None
    if case == "k = 2500":
        return quant_lib.QuantStore.build(normal(8000, 20)), normal(37, 20), 2500, None
    raise KeyError(case)


INT8_SPLIT_CASES = ["ties across a boundary", "a split masked", "k over one split",
                    "k over n", "ragged strips", "unaligned d = 13", "unaligned d = 21",
                    "k = 600", "k = 2500"]


@pytest.mark.parametrize("case", INT8_SPLIT_CASES)
def test_topk_int8_kernel_splits(cuda, case):
    """The int8 scan over S > 1 column ranges and the merge of their lists
    against the plain version, bit for bit: one counted launch,
    (distance, column) order across splits, (+inf, -1) past the valid
    candidates."""
    store, Q, k, valid = _int8_split_case(case, cuda)
    codes, scales, sqn = store.device_view()
    m, n = Q.shape[0], codes.shape[0]
    plan = int8_plan(m, n, k, cuda)
    assert len(plan) > 1, plan
    before = _build.launches()["topk/int8"]
    od, oi = topk_quant_cuda(Q, codes, scales, sqn, k=k, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()["topk/int8"] == before + 1
    rd, ri = topk_quant_ref(Q, codes, scales, sqn, k=k, valid=valid)
    assert torch.equal(od, rd) and torch.equal(oi, ri)
    live = n if valid is None else int(valid.sum())
    if k > live:
        assert torch.isinf(od[:, live:]).all() and (oi[:, live:] == -1).all()
    if case == "ties across a boundary":
        want = np.arange(64)[:, None] + np.array([0, 2048])
        assert (oi[:, :2].cpu().numpy() == want).all()
    if case == "a split masked":
        a, b = plan[1]
        assert not ((oi >= a) & (oi < b)).any()


@pytest.mark.parametrize("shape", QPATH_SHAPES + [(2048, 2048, 2048)])
@pytest.mark.parametrize("mode", MODES)
def test_qpath_kernel_matches_plain(cuda, shape, mode):
    m, k, n = shape
    rng = np.random.default_rng([*shape, MODES.index(mode)])
    A = torch.as_tensor(rng.uniform(0.05, 4.0, size=(m, k)).astype(np.float32), device=cuda)
    B = torch.as_tensor(rng.uniform(0.05, 4.0, size=(k, n)).astype(np.float32), device=cuda)
    A[torch.as_tensor(rng.random((m, k)) < 0.3, device=cuda)] = math.inf
    out = qpath_matmul_cuda(A, B, mode=mode)
    ref = qpath_matmul_ref(A, B, mode=mode)
    torch.cuda.synchronize()
    if mode == "logminplus":
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    else:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_qpath_kernel_infinities(cuda, mode):
    inf = math.inf
    A = torch.tensor([[0.0, inf], [1.0, 2.0]], device=cuda)
    B = torch.tensor([[0.5, inf], [inf, 1.0]], device=cuda)
    np.testing.assert_allclose(qpath_matmul_cuda(A, B, mode=mode).cpu().numpy(),
                               qpath_matmul_ref(A, B, mode=mode).cpu().numpy(), atol=1e-5)
    # a log-domain edge matrix: -inf diagonal (q log 0), +inf off-graph
    L = torch.tensor([[-inf, 1.0, inf], [1.0, -inf, 2.0], [inf, 2.0, -inf]], device=cuda)
    out = qpath_matmul_cuda(L, L, mode="logminplus")
    ref = qpath_matmul_ref(L, L, mode="logminplus")
    assert not torch.isnan(out).any()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)


def _late_sweep_operand(dev, mode: str) -> torch.Tensor:
    """A projection's operand after five doubling sweeps, by the plain
    version: the kNN graph of 300 manifold points with two random links a
    node (as the index build adds), in the mode's domain (log power for
    logminplus); dense once the links join the graph."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(synthetic.make("manifold", 300, seed=5), device=dev)
    idx = topk_ref(X, X, k=8, metric="euclidean", exclude_self=True)[1]
    links = torch.as_tensor(rng.integers(0, 300, size=(300, 2)), device=dev)
    eye = torch.eye(300, dtype=torch.bool, device=dev)
    mask = torch.zeros((300, 300), dtype=torch.bool, device=dev)
    rows = torch.arange(300, device=dev)[:, None]
    mask[rows, idx.long()] = True
    mask[rows, links] = True
    D = torch.where(eye, 0.0, pdist_ref(X, X, metric="euclidean"))
    M = torch.where(mask | mask.T | eye, D, math.inf)
    if mode == "logminplus":
        M = 2.0 * torch.log(M)
    for _ in range(5):
        M = torch.minimum(M, qpath_matmul_ref(M, M, mode=mode))
    return M


@pytest.mark.parametrize("mode", MODES)
def test_qpath_kernel_on_a_late_sweep_operand(cuda, mode, monkeypatch):
    from repro_torch.kernels.qpath import qpath as qpath_mod

    M = _late_sweep_operand(cuda, mode)
    assert torch.isfinite(M).float().mean() > 0.9
    ref = qpath_matmul_ref(M, M, mode=mode)
    out = qpath_matmul_cuda(M, M, mode=mode)
    if mode == "logminplus":
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    else:
        assert torch.equal(out, ref)
    # min is exact: any cut of k into splits gives the same bits
    for splits, per in ((2, 160), (5, 64), (10, 32)):
        monkeypatch.setattr(qpath_mod, "split_plan", lambda *a, plan=(splits, per): plan)
        assert torch.equal(qpath_matmul_cuda(M, M, mode=mode), out)


def test_projection_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(96, 6)).astype(np.float32)
    D = torch.cdist(torch.as_tensor(Xn), torch.as_tensor(Xn))
    D.fill_diagonal_(0.0)
    mask = torch.as_tensor(rng.random((96, 96)) < 0.1)
    for q in (2.0, math.inf):
        cpu = qmetric.sparse_canonical_projection(D, mask, q, num_hops=5,
                                                  schedule="doubling")
        gpu = qmetric.sparse_canonical_projection(D.to(cuda), mask.to(cuda), q,
                                                  num_hops=5, schedule="doubling")
        np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version(cuda):
    from repro_torch.kernels.pdist.ops import pdist

    before = _build.launches()
    X = torch.ones((3, 2))
    pdist(X, X, metric="euclidean")
    assert _build.launches() == before


def test_small_index_build_launches_every_kernel(cuda):
    X = synthetic.make("manifold", 600, seed=1)
    _build.reset_launches()
    index = index_lib.build("infinity", X, {
        "q": 2.0, "proj_sample": 256, "knn_k": 8, "num_hops": 4, "embed_dim": 16,
        "hidden": (64,), "train_steps": 50, "batch_pairs": 256,
    }, device=cuda)
    counts = _build.launches()
    assert counts == {"topk/f32": 1, "topk/cube": 0, "topk/int8": 0,
                      "pdist/matmul": 1, "pdist/cube": 0, "qpath/minplus": 0,
                      "qpath/minmax": 0, "qpath/logminplus": 4, "bag": 0,
                      "bag_backward": 0}
    res = index.search(X[:80], k=5, rerank=32, budget=512)
    torch.cuda.synchronize()
    assert res.idx.shape == (80, 5) and (res.idx >= 0).all()
    assert (res.dist[:, 1:] >= res.dist[:, :-1]).all()


def test_quantized_brute_and_manhattan_index_on_card(cuda):
    """The slice's two new paths through the registry, counted: brute with
    the quant key launches the int8 kernel once per search and no f32 scan;
    a manhattan build launches the cube regimes and no matmul regime."""
    X = synthetic.make("manifold", 600, seed=2)
    Q = X[:80]
    gt = index_lib.build("brute", X, {}, device=cuda).search(Q, k=10)
    eng = index_lib.build("brute", X, {"quant": True}, device=cuda)
    _build.reset_launches()
    res = eng.search(Q, k=10)
    torch.cuda.synchronize()
    counts = _build.launches()
    assert counts["topk/int8"] == 1 and counts["topk/f32"] == 0
    hits = [len(set(a) & set(b)) for a, b in zip(res.idx.tolist(), gt.idx.tolist())]
    assert sum(hits) / (10 * len(hits)) >= 0.99
    _build.reset_launches()
    index = index_lib.build("infinity", X, {
        "metric": "manhattan", "proj_sample": 256, "knn_k": 8, "num_hops": 4,
        "embed_dim": 16, "hidden": (64,), "train_steps": 50, "batch_pairs": 256,
    }, device=cuda)
    counts = _build.launches()
    assert counts["topk/cube"] == 1 and counts["pdist/cube"] == 1
    assert counts["topk/f32"] == 0 and counts["pdist/matmul"] == 0
    assert counts["qpath/minmax"] == 4
    res = index.search(Q, k=5, rerank=32, budget=512)
    torch.cuda.synchronize()
    assert res.idx.shape == (80, 5) and (res.idx >= 0).all()


@pytest.mark.parametrize("D", [1, 10, 16, 24])
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_kernel_matches_plain(cuda, D, combine, weighted):
    rng = np.random.default_rng([D, weighted])
    V, B, S = 5000, 700, 39
    table = torch.as_tensor(rng.normal(size=(V, D)).astype(np.float32), device=cuda)
    ids_np = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ids_np[rng.random((B, S)) < 0.1] = -1  # padding, some rows partly
    ids_np[5] = -3  # an all-padding row
    ids = torch.as_tensor(ids_np, device=cuda)
    w = (torch.as_tensor(rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32),
                         device=cuda) if weighted else None)
    before = _build.launches()["bag"]
    out = embedding_bag_cuda(table, ids, w, combine=combine)
    torch.cuda.synchronize()
    assert _build.launches()["bag"] == before + 1
    ref = embedding_bag_ref(table, ids, w, combine=combine)
    assert out.shape == (B, D) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    assert (out[5] == 0).all()
    # int64 ids take the same path
    assert torch.equal(embedding_bag_cuda(table, ids.long(), w, combine=combine), out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_kernel_half_table_matches_plain(cuda, dtype, combine):
    """A bf16 / f16 table read in its own dtype, converted exactly to f32:
    bit-identical to the plain version, and to the kernel on its f32 copy."""
    rng = np.random.default_rng(21)
    V, B, S, D = 5000, 700, 39, 10
    table = torch.as_tensor(rng.normal(size=(V, D)).astype(np.float32),
                            device=cuda).to(dtype)
    ids_np = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ids_np[rng.random((B, S)) < 0.1] = -1
    ids = torch.as_tensor(ids_np, device=cuda)
    w = torch.as_tensor(rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32), device=cuda)
    out = embedding_bag_cuda(table, ids, w, combine=combine)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    assert torch.equal(out, embedding_bag_ref(table, ids, w, combine=combine))
    assert torch.equal(out, embedding_bag_cuda(table.float(), ids, w, combine=combine))


def test_bag_kernel_edges(cuda):
    table = _normal((10, 3), 5, cuda)
    empty = embedding_bag_cuda(table, torch.zeros((0, 4), dtype=torch.int32, device=cuda))
    assert empty.shape == (0, 3)
    one = torch.tensor([[2, -1, 7]], dtype=torch.int32, device=cuda)
    assert torch.equal(embedding_bag_cuda(table, one), (table[2] + table[7])[None])
    table[0] = math.inf  # padding still forms 0 * row 0
    assert torch.isnan(embedding_bag_cuda(table, one)).all()
    with pytest.raises(ValueError, match="f32, bf16 or f16 table"):
        embedding_bag_cuda(table.to(torch.int32), one)
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag_cuda(table, one.cpu())


def _bag_case(dev, B, S, D, seed, pad=0.1, weighted=True, V=5000):
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.normal(size=(V, D)).astype(np.float32), device=dev)
    ids_np = rng.integers(0, V, size=(B, S)).astype(np.int32)
    ids_np[rng.random((B, S)) < pad] = -1
    ids = torch.as_tensor(ids_np, device=dev)
    w = (torch.as_tensor(rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32), device=dev)
         if weighted else None)
    return table, ids, w


# (B, S, D): B not a multiple of the tile (the thread path's bags: 256 at
# B = 262145 and D = 1, 3 at D = 10 and B = 52), S = 1, 7 and 100, B * D
# under one warp, and both paths (launch_plan takes the warp path at
# (33, 39, 1), (700, 7, 1), (1, 1, 1) and (2, 5, 3))
BAG_EDGE_SHAPES = [(33, 39, 1), (262145, 39, 1), (52, 39, 10), (700, 1, 10), (700, 7, 1),
                   (300, 100, 16), (3, 39, 10), (1, 1, 1), (2, 5, 3)]


@pytest.mark.parametrize("shape", BAG_EDGE_SHAPES)
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_kernel_edge_shapes(cuda, shape, combine, weighted):
    B, S, D = shape
    table, ids, w = _bag_case(cuda, B, S, D, seed=sum(shape), weighted=weighted)
    out = embedding_bag_cuda(table, ids, w, combine=combine)
    assert torch.equal(out, embedding_bag_ref(table, ids, w, combine=combine))


@pytest.mark.parametrize("chunk", bag_mod.CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_bag_kernel_every_instance(cuda, chunk, dtype):
    """Each instanced chunk, forced through the plan, at blocks of 32 and
    256 threads, with more outputs than threads (two passes) and with S cut
    into windows (one bag a block), and the warp path at 1, 3 and 8 warps a
    block: all bit-identical to the plain version."""
    B, S, D = 300, 39, 10
    table, ids, w = _bag_case(cuda, B, S, D, seed=chunk)
    table = table.to(dtype)
    ref = embedding_bag_ref(table, ids, w, combine="mean")
    plans = [bag_mod.BagPlan(threads, bags, chunk, window, 0)
             for threads, bags, window in ((32, 3, S), (256, 25, S), (32, 4, S), (32, 1, 9),
                                           (32, 1, 16))]
    plans += [bag_mod.BagPlan(32 * warps, warps, S, S, 0, True) for warps in (1, 3, 8)]
    for plan in plans:
        out = embedding_bag_cuda(table, ids, w, combine="mean", plan=plan)
        assert torch.equal(out, ref), plan
    with pytest.raises(RuntimeError, match="bag_f32"):
        embedding_bag_cuda(table, ids, w, plan=bag_mod.BagPlan(32, 3, chunk + 1, S, 0))


@pytest.mark.parametrize("D", [1, 10])
def test_bag_kernel_unaligned_row_slices(cuda, D):
    """ids and weights as row-slice views whose base is not 16-byte
    aligned (S = 39: a row is 156 bytes): the staging copies start
    anywhere."""
    table, ids, w = _bag_case(cuda, 600, 39, D, seed=D)
    for first in (1, 2, 3, 5):
        sub, sw = ids[first:], w[first:]
        assert sub.data_ptr() % 16 != 0 and sub.is_contiguous()
        out = embedding_bag_cuda(table, sub, sw, combine="sum")
        assert torch.equal(out, embedding_bag_ref(table, sub, sw, combine="sum"))
        assert torch.equal(out, embedding_bag_cuda(table, sub.clone(), sw.clone()))


@pytest.mark.parametrize("shape", [(512, 39, 1), (262144, 39, 1), (1, 39, 10), (32, 39, 10)])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_kernel_padding_at_deepfm_shapes(cuda, shape, combine):
    """All-padding and partly padded bags at phase 7's shapes (serve_p99,
    serve_bulk, retrieval_cand, the infinity retrieval): an all-padding bag
    is 0 under both combines, and every bag equals the plain version."""
    B, S, D = shape
    table, ids, w = _bag_case(cuda, B, S, D, seed=B + D, pad=0.3, V=100000)
    ids[0] = -1
    ids[B // 2, S // 2:] = -1
    for wts in (None, w):
        out = embedding_bag_cuda(table, ids, wts, combine=combine)
        assert torch.equal(out, embedding_bag_ref(table, ids, wts, combine=combine))
        assert (out[0] == 0).all()


@pytest.mark.parametrize("arch", ["fm", "deepfm", "xdeepfm", "autoint"])
def test_recsys_serving_on_card_matches_cpu(cuda, arch):
    """The reduced config served on the card (the bag kernel for the
    first-order term and the user embedding) against the same weights on
    the CPU (the plain version)."""
    from repro_torch import configs
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models import params, recsys
    from repro_torch.train.train_step import make_retrieval_step, make_serve_step

    cfg = configs.get_reduced(arch)
    model = recsys.RecsysModel.build(cfg, device=cuda)
    cpu = recsys.RecsysModel(cfg, params.map_decls(
        lambda path, _: model.get_parameter(path).detach().cpu(), recsys.recsys_decls(cfg)))
    ids = recsys_batch(0, 256, cfg.vocabs, seed=4)["ids"]
    _build.reset_launches()
    probs = make_serve_step(cfg, "recsys")(model, {"ids": torch.as_tensor(ids, device=cuda)})
    torch.cuda.synchronize()
    assert _build.launches()["bag"] == 1
    ref = make_serve_step(cfg, "recsys")(cpu, {"ids": torch.as_tensor(ids)})
    np.testing.assert_allclose(probs.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    cand = _normal((3000, cfg.embed_dim), 6, cuda)
    s, i = make_retrieval_step(cfg, k=50)(
        model, {"ids": torch.as_tensor(ids[:3], device=cuda), "candidates": cand})
    rs, ri = make_retrieval_step(cfg, k=50)(
        cpu, {"ids": torch.as_tensor(ids[:3]), "candidates": cand.cpu()})
    np.testing.assert_allclose(s.cpu().numpy(), rs.numpy(), rtol=1e-5, atol=1e-5)
    assert (i.cpu() == ri).float().mean() >= 0.98  # near ties may swap


# ---------------------------------------------------------------------------
# filters and the IVF / NSW engines on the card
# ---------------------------------------------------------------------------

ENGINES = [
    ("brute", {}),
    ("brute", {"quant": True}),
    ("ivf_flat", {"num_clusters": 16, "nprobe": 4}),
    ("ivf_flat", {"num_clusters": 16, "nprobe": 4, "quant": True}),
    ("ivf_pq", {"num_clusters": 16, "M": 8, "ksub": 32, "nprobe": 4, "rerank": 32}),
    ("ivf_pq", {"num_clusters": 16, "M": 8, "ksub": 32, "nprobe": 4}),
    ("nsw", {"degree": 12, "ef": 32, "max_steps": 64}),
]


def _filter_data(n=1500, seed=4):
    X = synthetic.make("manifold", n + 64, d=48, seed=seed)
    rng = np.random.default_rng(seed)
    attrs = {"score": rng.uniform(size=n).astype(np.float32),
             "category": [f"c{i % 8}" for i in range(n)]}
    return X[:n], X[n:], attrs


@pytest.mark.parametrize("name,cfg", ENGINES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(ENGINES)])
@pytest.mark.parametrize("flt", [None, {"score": {"range": [None, 0.1]}},
                                 {"category": ["c1", "c5"], "score": {"range": [0.2, 0.9]}}])
def test_engines_on_card_match_cpu(cuda, name, cfg, flt):
    """An engine built on the CPU and loaded onto the card (the same
    centroids, lists, codes and graph) returns the CPU's ids and
    comparisons, filtered or not; the card's search runs its kernels (the
    masked regimes under a filter) and returns no failing id."""
    from repro_torch.core import filter as filter_lib

    X, Q, attrs = _filter_data()
    cfg = cfg | {"attrs": attrs}
    cpu = index_lib.build(name, X, cfg, device="cpu")
    arrays, statics = cpu.snapshot_state()
    card = type(cpu).from_snapshot({k: v.cpu().numpy() for k, v in arrays.items()}, statics,
                                   device=cuda)
    index_lib.attach_store(card, cpu.attrs)
    if getattr(cpu, "quant", None) is not None:
        index_lib.attach_quant_store(card, quant_lib.QuantStore.from_snapshot(
            cpu.quant.snapshot_state()[0], {}, device=cuda))
    want = cpu.search(Q, k=10, filter=flt)
    _build.reset_launches()
    got = card.search(Q, k=10, filter=flt)
    torch.cuda.synchronize()
    counts = _build.launches()
    assert got.idx.is_cuda
    assert_same_ids(got.idx, got.dist, want.idx, want.dist)
    assert torch.equal(got.comparisons.cpu(), want.comparisons)
    if name == "brute":
        assert counts["topk/int8" if cfg.get("quant") else "topk/f32"] == 1
    if name.startswith("ivf"):
        assert counts["pdist/matmul"] == 1  # the coarse probe
    if flt is not None:
        mask = filter_lib.resolve_mask(flt, card.attrs, X.shape[0], cuda)
        ids = got.idx.long()
        assert bool(mask[ids.clamp_min(0)][ids >= 0].all())


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("s", [0.5, 0.1, 0.01])
def test_filtered_brute_on_card_is_the_sub_corpus_scan(cuda, quant, s):
    """Filtered brute on the card (the masked topk / int8 kernel, one
    launch) equals the plain scan over the passing rows, ids mapped back;
    the quantized scan where every passing row reaches its shortlist."""
    X, Q, attrs = _filter_data(4000, seed=5)
    mask = attrs["score"] <= s
    eng = index_lib.build("brute", X, {"attrs": attrs, "quant": quant}, device=cuda)
    _build.reset_launches()
    res = eng.search(Q, k=10, filter={"score": {"range": [None, s]}})
    torch.cuda.synchronize()
    assert _build.launches()["topk/int8" if quant else "topk/f32"] == 1
    rows = np.where(mask)[0]
    sd, si = topk_ref(torch.as_tensor(Q, device=cuda), torch.as_tensor(X[mask], device=cuda),
                      k=10, metric="euclidean")
    ref = torch.where(si >= 0, torch.as_tensor(rows, device=cuda)[si.long().clamp_min(0)], -1)
    if not quant or mask.sum() <= quant_lib.shortlist_width(10, X.shape[0]):
        assert_same_ids(res.idx, res.dist, ref, sd)
    else:
        hits = [len(set(a) & set(b)) for a, b in zip(res.idx.tolist(), ref.tolist())]
        assert sum(hits) / (10 * len(hits)) >= 0.99
    assert bool(torch.as_tensor(mask, device=cuda)[res.idx.long().clamp_min(0)].all())


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_chunked_candidate_gather_on_card_matches_one_chunk(cuda, monkeypatch, metric):
    """The candidate gather split over queries (``scan.in_chunks``) gives
    the one-chunk answer bit for bit, f32 and on codes."""
    from repro_torch.core import scan as scan_lib

    X, Q, _ = _filter_data(3000, seed=6)
    Xt, Qt = torch.as_tensor(X, device=cuda), torch.as_tensor(Q, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    cand = torch.randint(-1, X.shape[0], (Q.shape[0], 700), generator=g, device=cuda)
    codes, scales, _ = quant_lib.QuantStore.build(Xt).device_view()
    whole = (scan_lib.topk_candidates(Qt, cand, Xt, k=10, metric=metric),
             scan_lib.quant_candidates(Qt, cand, codes, scales, k=40, metric=metric))
    monkeypatch.setattr(scan_lib, "GATHER_BYTES", 5 * 4 * 700 * X.shape[1])
    parts = (scan_lib.topk_candidates(Qt, cand, Xt, k=10, metric=metric),
             scan_lib.quant_candidates(Qt, cand, codes, scales, k=40, metric=metric))
    for w, p in zip(whole, parts):
        assert torch.equal(w[0], p[0]) and torch.equal(w[1], p[1])


def test_kmeans_and_nsw_build_on_card_match_cpu(cuda):
    """Lloyd's iterations on the card (the pdist kernel) from the CPU's
    initial centroids give the CPU's assignment; the NSW graph built on the
    card (the topk kernel, self excluded) has the CPU's neighbours up to
    near ties, and the same long links and entry."""
    from repro_torch.core import baselines

    X, _, _ = _filter_data(2000, seed=7)
    init = X[np.random.default_rng(0).choice(X.shape[0], 24, replace=False)]
    cc, ca = baselines._lloyd(torch.as_tensor(X), torch.as_tensor(init), 10)
    gc, ga = baselines._lloyd(torch.as_tensor(X, device=cuda), torch.as_tensor(init, device=cuda),
                              10)
    assert torch.equal(ga.cpu(), ca)
    np.testing.assert_allclose(gc.cpu().numpy(), cc.numpy(), rtol=1e-5, atol=5e-4)
    cpu = index_lib.build("nsw", X, {"degree": 12}, device="cpu")
    _build.reset_launches()
    card = index_lib.build("nsw", X, {"degree": 12}, device=cuda)
    assert _build.launches()["topk/f32"] == 1
    assert card.entry == cpu.entry
    assert torch.equal(card.neighbors[:, 12:].cpu(), cpu.neighbors[:, 12:])
    d = lambda ids: torch.linalg.norm(  # noqa: E731
        torch.as_tensor(X)[:, None] - torch.as_tensor(X)[ids.long()], dim=-1)
    assert_same_ids(card.neighbors[:, :12].cpu(), d(card.neighbors[:, :12].cpu()),
                    cpu.neighbors[:, :12], d(cpu.neighbors[:, :12]))


# ---------------------------------------------------------------------------
# serving, live mutation and snapshots on the card
# ---------------------------------------------------------------------------

SERVE_ENGINES = {
    "brute": {},
    "brute+quant": {"quant": True},
    "ivf_flat": {"num_clusters": 16, "nprobe": 4},
    "ivf_pq": {"num_clusters": 16, "M": 8, "ksub": 32, "nprobe": 4, "rerank": 32},
    "nsw": {"degree": 12, "ef": 32, "max_steps": 64},
    "infinity": {"q": math.inf, "proj_sample": 512, "knn_k": 8, "num_hops": 4,
                 "embed_dim": 16, "hidden": (64,), "train_steps": 100,
                 "batch_pairs": 256, "rerank": 64},
}


@pytest.fixture(scope="module")
def serve_snapshots(tmp_path_factory):
    """{engine: snapshot path} of engines built on the CPU (with the demo
    attribute columns), the corpus and queries."""
    from repro_torch.core import store as store_lib

    X, Q, attrs = _filter_data(2000, seed=8)
    root = tmp_path_factory.mktemp("card_snaps")
    paths = {}
    for name, cfg in SERVE_ENGINES.items():
        engine = name.split("+")[0]
        eng = index_lib.build(engine, X, dict(cfg) | {"attrs": attrs}, device="cpu")
        paths[name] = store_lib.save(eng, str(root / name.replace("+", "_")))
    return paths, X, Q


@pytest.mark.parametrize("batch", [1, 7, 40, 64])
@pytest.mark.parametrize("name", list(SERVE_ENGINES))
def test_restored_server_on_card_matches_cpu(cuda, serve_snapshots, name, batch):
    """``SearchServer.restore`` of one snapshot on the card and on the CPU:
    the same ids (near ties aside) and comparisons, filtered or not; the
    card's answers come back as host arrays."""
    from repro_torch.launch.serve import SearchServer

    paths, _, Q = serve_snapshots
    card = SearchServer.restore(paths[name], device=cuda)
    cpu = SearchServer.restore(paths[name], device="cpu")
    assert card.corpus.is_cuda and card.index.memory_bytes() == cpu.index.memory_bytes()
    for flt in (None, {"score": {"range": [None, 0.3]}}):
        got = card.query(Q[:batch], k=10, budget=512, filter=flt)
        want = cpu.query(Q[:batch], k=10, budget=512, filter=flt)
        assert isinstance(got.idx, np.ndarray)
        assert_same_ids(got.idx, got.dist, want.idx, want.dist)
        np.testing.assert_array_equal(got.comparisons, want.comparisons)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("engine", ["brute", "infinity"])
def test_live_index_on_card_matches_cpu(cuda, serve_snapshots, engine, quant):
    """One live snapshot restored on the card and on the CPU, then the
    same upsert / delete / refresh-or-full compaction script: equal ids
    from upsert and compact, search ids equal up to near ties; the card's
    delta scan launches the masked topk (f32) or the int8 topk (quant)
    once per search."""
    from repro_torch.core import store as store_lib

    paths, X, Q = serve_snapshots
    rng = np.random.default_rng(3)
    Xnew = rng.normal(size=(96, X.shape[1])).astype(np.float32)
    cfg = {"engine": engine, "engine_cfg": dict(SERVE_ENGINES[engine]),
           "delta_cap": 128, "auto_compact": False,
           "compact_mode": "refresh" if engine == "infinity" else "full"}
    if quant:
        cfg["quant"] = True
    seed = index_lib.build("live", X, cfg, device="cpu")
    seed.upsert(Xnew[:8])
    seed.delete([2, 5])
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = store_lib.save(seed, td)
        card, cpu = store_lib.load(path, device=cuda), store_lib.load(path, device="cpu")
    for step in range(3):
        ids = card.upsert(Xnew[8 + 24 * step:32 + 24 * step])
        assert np.array_equal(ids, cpu.upsert(Xnew[8 + 24 * step:32 + 24 * step]))
        assert card.delete(ids[:3]) == cpu.delete(ids[:3])
        _build.reset_launches()
        got = card.search(Q, k=10)
        torch.cuda.synchronize()
        counts = _build.launches()
        want = cpu.search(Q, k=10)
        assert_same_ids(got.idx, got.dist, want.idx, want.dist)
        assert counts["topk/int8" if quant else "topk/f32"] >= 1
        own = card.search(torch.as_tensor(Xnew[11 + 24 * step:32 + 24 * step], device=cuda),
                          k=1)
        assert np.array_equal(own.idx[:, 0].cpu().numpy(), ids[3:])
    assert np.array_equal(card.compact(), cpu.compact())
    assert card.stats() == cpu.stats()
    got, want = card.search(Q, k=10), cpu.search(Q, k=10)
    assert_same_ids(got.idx, got.dist, want.idx, want.dist)


def test_store_round_trip_on_card(cuda, serve_snapshots, tmp_path):
    """A snapshot saved from the card loads on the CPU (and back) with
    every member equal."""
    from repro_torch.core import store as store_lib

    paths, _, Q = serve_snapshots
    for name, path in paths.items():
        card = store_lib.load(path, device=cuda)
        again = store_lib.save(card, str(tmp_path / name.replace("+", "_")))
        for p in (path, again):
            store_lib.verify(p)
        with np.load(os.path.join(path, store_lib.peek(path)["arrays"])) as a, \
                np.load(os.path.join(again, store_lib.peek(again)["arrays"])) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name}: {key}")


# ------------------------------------------------------------ sharded engines

@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_brute_equals_one_shard_on_the_card(cuda, shards):
    """Every shard on the card: S = 2 / 4 brute answers as one shard does
    (f32 ids equal but near ties), and its answer on the card is the CPU
    answer; quantized shards never rank worse than one quantized shard."""
    X = torch.as_tensor(synthetic.make("manifold", 4096 + 64, seed=3)[:, :32].copy())
    Y, Q = X[:4096], X[4096:]
    one = index_lib.build("brute", Y, {}, device=cuda).search(Q.to(cuda), k=11)
    sh = index_lib.build("sharded", Y, {"engine": "brute", "shards": shards}, device=cuda)
    _build.reset_launches()
    res = sh.search(Q.to(cuda), k=10)
    torch.cuda.synchronize()
    assert _build.launches()["topk/f32"] == shards
    assert_same_ids(res.idx, res.dist, one.idx[:, :10], one.dist[:, :10])
    cpu = index_lib.build("sharded", Y, {"engine": "brute", "shards": shards},
                          device="cpu").search(Q, k=10)
    assert_same_ids(res.idx, res.dist, cpu.idx, cpu.dist)
    qone = index_lib.build("brute", Y, {"quant": True}, device=cuda).search(Q.to(cuda), k=10)
    qsh = index_lib.build("sharded", Y, {"engine": "brute", "shards": shards, "quant": True},
                          device=cuda).search(Q.to(cuda), k=10)
    assert bool((qsh.dist <= qone.dist + 5e-4 + 1e-5 * qone.dist.abs()).all())


# the bag's backward (csrc/bag.cu:bag_backward): f32 atomics land in any
# order, so on gradients of any value it agrees with the plain backward to
# rounding only.  The cases below are made so that no order rounds: small
# integer weights and gradients (under mean an integer times the bag's
# weight sum) make every contribution and partial sum an exact f32 integer
# (tests/test_torch_bag_grad.py), and the kernel must equal the plain
# backward bit for bit; a row that every bag names (the 100-id field) then
# fails on any dropped or misplaced add.  Rows named once hold the
# products' rounding on normal values.
def _exact_grad(ids, V, weighted, D, combine, seed):
    """Integer-valued (g, weights) for ``ids``, and the most any row's
    partial sums reach (< 2^24: exact in f32)."""
    from repro_torch.kernels.bag.ref import bag_scale, embedding_bag_backward_ref

    rng = np.random.default_rng(seed)
    B, S = ids.shape
    w = (torch.as_tensor(rng.integers(1, 4, size=(B, S)).astype(np.float32),
                         device=ids.device) if weighted else None)
    k = torch.as_tensor(rng.integers(-4, 5, size=(B, D)).astype(np.float32), device=ids.device)
    g = k * bag_scale(ids, w, combine)[1]
    reach = embedding_bag_backward_ref(k.abs(), ids, w, V)
    return g, w, float(reach.max())


# (B, S, D, V): DeepFM's first-order term at the train batch (ids from 39
# fields of few rows each, so rows repeat across bags), a 100-id field at
# B = 65 536 (about 59 000 adds a row), duplicates within a bag, one bag,
# one id
BAG_GRAD_SHAPES = [(65536, 39, 1, 5000), (65536, 100, 1, 100), (300, 39, 10, 50),
                   (1, 7, 3, 4), (5, 1, 1, 2)]


@pytest.mark.parametrize("shape", BAG_GRAD_SHAPES)
@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_backward_kernel_matches_plain(cuda, shape, combine, weighted):
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref

    B, S, D, V = shape
    _, ids, _ = _bag_case(cuda, B, S, D, seed=sum(shape), pad=0.1, weighted=False, V=V)
    ids[0] = -1  # an all-padding bag
    g, w, reach = _exact_grad(ids, V, weighted, D, combine, seed=9)
    assert reach < 2 ** 24
    before = _build.launches()["bag_backward"]
    out = embedding_bag_backward_cuda(g, ids, w, V, combine=combine)
    torch.cuda.synchronize()
    assert _build.launches()["bag_backward"] == before + 1
    ref = embedding_bag_backward_ref(g, ids, w, V, combine=combine)
    assert out.shape == (V, D) and out.dtype == torch.float32
    assert torch.equal(out, ref), float((out - ref).abs().max())
    assert torch.equal(embedding_bag_backward_cuda(g, ids.long(), w, V, combine=combine), out)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_backward_kernel_rounds_products_as_plain(cuda, combine, weighted):
    """Normal gradients and real weights, every row named at most once: each
    row holds one product, rounded as the plain version rounds it."""
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda
    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref

    B, S, D = 4096, 39, 3
    V = B * S + 17
    rng = np.random.default_rng(4)
    ids_np = rng.permutation(V)[:B * S].reshape(B, S).astype(np.int32)
    ids_np[rng.random((B, S)) < 0.1] = -1
    ids = torch.as_tensor(ids_np, device=cuda)
    w = (torch.as_tensor(rng.uniform(0.5, 1.5, size=(B, S)).astype(np.float32), device=cuda)
         if weighted else None)
    g = _normal((B, D), 7, cuda)
    out = embedding_bag_backward_cuda(g, ids, w, V, combine=combine)
    assert torch.equal(out, embedding_bag_backward_ref(g, ids, w, V, combine=combine))


def test_bag_backward_kernel_refuses(cuda):
    from repro_torch.kernels.bag import ops
    from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda

    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="f32 output gradient"):
        embedding_bag_backward_cuda(torch.zeros((2, 4), dtype=torch.float64, device=cuda),
                                    ids, None, 10)
    with pytest.raises(ValueError, match="CUDA tensors"):
        embedding_bag_backward_cuda(torch.zeros((2, 4), device=cuda), ids.cpu(), None, 10)
    t64 = torch.zeros((10, 4), dtype=torch.float64, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="f32, bf16 or f16 table"):
        ops.embedding_bag(t64, ids)


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_bag_autograd_on_card_launches_both_kernels(cuda, combine):
    from repro_torch.kernels.bag import ops
    from repro_torch.kernels.bag.ref import embedding_bag_backward_ref

    table, ids, _ = _bag_case(cuda, 4096, 39, 1, seed=5, V=3000, weighted=False)
    g, w, _ = _exact_grad(ids, 3000, True, 1, combine, seed=6)
    t = table.clone().requires_grad_(True)
    _build.reset_launches()
    out = ops.embedding_bag(t, ids, w, combine=combine)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    counts = _build.launches()
    assert counts["bag"] == 1 and counts["bag_backward"] == 1
    assert torch.equal(out.detach(), embedding_bag_ref(table, ids, w, combine=combine))
    assert torch.equal(t.grad, embedding_bag_backward_ref(g, ids, w, 3000, combine=combine))


@pytest.mark.parametrize("arch", ["fm", "deepfm", "xdeepfm", "autoint"])
@pytest.mark.parametrize("mode", [{}, {"microbatches": 2}, {"grad_compression": "int8"}])
def test_recsys_train_step_on_card_matches_cpu(cuda, arch, mode):
    """Three AdamW steps of the reduced config on the card (the bag and its
    backward kernel) against the same steps on the CPU: losses rtol 1e-5,
    parameters rtol 1e-5 / atol 1e-6 (sums in another order, atomics)."""
    from repro_torch import configs
    from repro_torch.data.tokens import recsys_batch
    from repro_torch.models import params, recsys
    from repro_torch.train import optimizer, tree
    from repro_torch.train.train_step import make_train_step

    cfg = configs.get_reduced(arch)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p_gpu = params.init_params(recsys.recsys_decls(cfg), generator=gen, device=cuda)
    p_cpu = tree.tree_map(lambda t: t.cpu(), p_gpu)
    opt = optimizer.adamw(1e-3)
    s_gpu, s_cpu = opt.init(p_gpu), opt.init(p_cpu)
    step = make_train_step(cfg, "recsys", opt, **mode)
    _build.reset_launches()
    for t in range(3):
        b = recsys_batch(t, 64, cfg.vocabs)
        p_gpu, s_gpu, m_gpu = step(p_gpu, s_gpu, {k: torch.as_tensor(v, device=cuda)
                                                  for k, v in b.items()})
        p_cpu, s_cpu, m_cpu = step(p_cpu, s_cpu, {k: torch.as_tensor(v) for k, v in b.items()})
        assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-5)
    torch.cuda.synchronize()
    per = 3 * mode.get("microbatches", 1)
    assert _build.launches()["bag"] == per and _build.launches()["bag_backward"] == per
    for (key, a), (_, b) in zip(tree.paths(p_gpu), tree.paths(p_cpu)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_checkpoint_restores_on_the_card(cuda, tmp_path):
    from repro_torch.train import checkpoint, optimizer

    params = {"table": _normal((1000, 10), 1, cuda), "bias": torch.zeros(1, device=cuda)}
    opt = optimizer.adamw()
    state = opt.init(params)
    saver = checkpoint.AsyncCheckpointer(str(tmp_path))
    saver.save(4, (params, state))
    saver.wait()
    (p, s), step = checkpoint.restore(str(tmp_path), (params, state))
    assert step == 4 and s.step == 0 and p["table"].is_cuda
    assert torch.equal(p["table"], params["table"])


# ---------------------------------------------------------------------------
# the GCN and dense-LM serving on the card: no kernel lies on either path,
# so every launch counter stays 0
# ---------------------------------------------------------------------------

def _gcn_graph(seed, n=300, d=24, e=1500, classes=7):
    g = np.random.default_rng(seed)
    edges = np.concatenate([g.integers(0, n, size=(2, e)), np.full((2, 13), -1)], axis=1)
    return {"x": g.normal(size=(n, d)).astype(np.float32),
            "edges": edges.astype(np.int32),
            "labels": g.integers(0, classes, size=n).astype(np.int32),
            "label_mask": (g.random(n) < 0.5).astype(np.float32)}


@pytest.mark.parametrize("mode", [{}, {"grad_compression": "int8"}])
def test_gcn_on_card_matches_cpu(cuda, mode):
    """GCN CONFIG on a padded random graph: the serve step's logits rtol /
    atol 1e-5 and three AdamW(1e-2) steps' losses rtol 1e-5 against the CPU
    (``index_add`` sums with atomics on the card); no kernel launched."""
    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.train import optimizer, tree
    from repro_torch.train.train_step import make_serve_step, make_train_step

    cfg = configs.get("gcn-cora")
    model = gnn.GCNModel.build(cfg, 24, device=cuda)
    p_gpu = model.tree()
    p_cpu = tree.tree_map(lambda t: t.cpu(), p_gpu)
    b = _gcn_graph(2)
    gpu_b = {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}
    cpu_b = {k: torch.as_tensor(v) for k, v in b.items()}
    _build.reset_launches()
    serve = make_serve_step(cfg, "gnn")
    np.testing.assert_allclose(serve(p_gpu, gpu_b).cpu().numpy(),
                               serve(p_cpu, cpu_b).numpy(), rtol=1e-5, atol=1e-5)
    opt = optimizer.adamw(1e-2)
    s_gpu, s_cpu = opt.init(p_gpu), opt.init(p_cpu)
    step = make_train_step(cfg, "gnn", opt, **mode)
    for _ in range(3):
        p_gpu, s_gpu, m_gpu = step(p_gpu, s_gpu, gpu_b)
        p_cpu, s_cpu, m_cpu = step(p_cpu, s_cpu, cpu_b)
        assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b", "deepseek-coder-33b",
                                  "qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_lm_decode_on_card_equals_forward(cuda, arch):
    """REDUCED (f32), TF32 off: every position's logits through the cache
    equal the full forward's on the card, rtol / atol 1e-4."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_reduced(arch)
    model = transformer.LMModel.build(cfg, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)),
                           device=cuda)
    with torch.inference_mode():
        full = model(toks)
        cache = transformer.init_cache(cfg, 2, 16, device=cuda)
        steps = [transformer.lm_decode_step(model, cache, toks[:, t:t + 1], t, cfg)[0][:, 0]
                 for t in range(16)]
    np.testing.assert_allclose(torch.stack(steps, 1).cpu().numpy(), full.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma-2b", "deepseek-coder-33b"])
def test_lm_on_card_matches_cpu(cuda, arch, monkeypatch):
    """REDUCED (f32), the same weights and prompt: forward, prefill (its
    cache too), 4 decode steps fed the same tokens (their logits and the
    cache) and the chunked path (CHUNK_THRESHOLD / CHUNK_SIZE 16 / 8) on
    the card against the CPU, rtol / atol 1e-5; no kernel launched."""
    from repro_torch import configs
    from repro_torch.models import attention, transformer
    from repro_torch.train.train_step import make_prefill_step

    cfg = configs.get_reduced(arch)
    gpu = transformer.LMModel.build(cfg, device=cuda)
    cpu = transformer.LMModel(cfg, _cpu_tree(gpu.tree()))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    _build.reset_launches()
    prefill = make_prefill_step(cfg, max_len=16)
    outs = []
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        t = torch.as_tensor(toks, device=dev)
        with torch.inference_mode():
            logits = model(t[:, :12])
            last, cache = prefill(model, t[:, :12])
            steps = [transformer.lm_decode_step(model, cache, t[:, i:i + 1], i, cfg)[0]
                     for i in range(12, 16)]
        outs.append((logits, last, torch.cat(steps, 1), cache["dense"]["k"],
                     cache["dense"]["v"]))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(attention, "CHUNK_SIZE", 8)
    long = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    with torch.inference_mode():
        a = gpu(torch.as_tensor(long, device=cuda))
        b = cpu(torch.as_tensor(long))
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


def _cpu_tree(tree):
    from repro_torch.train import tree as tree_lib

    return tree_lib.tree_map(lambda t: t.cpu(), tree)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_moe_dispatch_on_card_matches_dense(cuda, arch, monkeypatch):
    """REDUCED (f32), TF32 off: one MoE layer's dispatch (whole, and in
    token chunks of 7 with experts in groups of 3) against the dense path
    on the card and against the dispatch on the CPU, rtol / atol 1e-5; no
    kernel launched."""
    from repro_torch import configs
    from repro_torch.models import moe, transformer

    cfg = configs.get_reduced(arch)
    model = transformer.LMModel.build(cfg, device=cuda)
    layer = {k: v[0] for k, v in model.tree()["moe_blocks"]["mlp"].items()}
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(3, 21, cfg.d_model)),
                        dtype=torch.float32, device=cuda)
    _build.reset_launches()
    outs = []
    for chunk, group in ((moe.MOE_CHUNK_TOKENS, moe.EXPERT_GROUP), (7, 3)):
        monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", chunk)
        monkeypatch.setattr(moe, "EXPERT_GROUP", group)
        with torch.inference_mode():
            probs = moe.router_probs(x, layer["router"], cfg)
            top_w, top_i = moe.topk_weights(probs, cfg)
            out = moe.moe_ffn_dispatch(x, top_w, top_i, layer, cfg)
            dense = moe.moe_ffn_dense(x, probs, layer, cfg)
            cpu_layer = {k: v.cpu() for k, v in layer.items()}
            cpu = moe.moe_ffn_dispatch(x.cpu(), top_w.cpu(), top_i.cpu(), cpu_layer, cfg)
        np.testing.assert_allclose(out.cpu().numpy(), dense.cpu().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), rtol=1e-5, atol=1e-5)
        outs.append(out)
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


#: mode -> (num_experts, moe_d_ff, impl): on a (2, 4) mesh, E = 8 gives 2d,
#: E = 4 fslice, E = 4 with an odd moe_d_ff model
EP_MODES = {"2d": (8, 64, "gathered"), "fslice": (4, 64, "gathered"),
            "model": (4, 63, "gathered"), "zero3": (8, 64, "zero3")}


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("mode", list(EP_MODES))
def test_moe_ep_on_card_matches_cpu(cuda, mode, cf):
    """The expert-parallel MoE on a (2, 4) mesh of ranks on the card
    against the same mesh on the CPU (REDUCED qwen3-moe widths, f32, TF32
    off), rtol / atol 1e-5, at capacity 1.25 (slots drop) and 8.0; the
    ranks' expert ids and drops are the same on both (no tie in f32
    probabilities drawn from normals); no kernel launched."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    E, f, impl = EP_MODES[mode]
    cfg = dataclasses.replace(configs.get_reduced("qwen3-moe-235b-a22b"), num_experts=E,
                              moe_d_ff=f, capacity_factor=cf)
    rng = np.random.default_rng(5)
    d = cfg.d_model
    host = {"x": rng.normal(size=(4, 16, d)),
            "probs": torch.softmax(torch.as_tensor(rng.normal(size=(4, 16, E))), -1).numpy(),
            "wg": rng.normal(size=(E, d, f)) * 0.05, "wu": rng.normal(size=(E, d, f)) * 0.05,
            "wd": rng.normal(size=(E, f, d)) * 0.05}
    fn = moe.moe_ffn_ep_zero3 if impl == "zero3" else moe.moe_ffn_ep
    _build.reset_launches()
    outs = []
    for dev in (cuda, torch.device("cpu")):
        t = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in host.items()}
        mesh = make_test_mesh((2, 4), device=dev)
        with torch.inference_mode():
            outs.append(fn(t["x"], t["probs"], t, cfg, mesh=mesh, batch_axes=("data",)))
    assert outs[0].device.type == "cuda"
    np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].numpy(), rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_lm_under_lm_policy_on_card_matches_cpu(cuda, arch):
    """REDUCED (f32), TF32 off, ``lm_policy`` on a (2, 4) mesh (its MoE
    layers expert-parallel, 2d): prefill and 3 decode steps on the card
    against the CPU, rtol / atol 1e-5; no kernel launched."""
    from repro_torch import configs
    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer

    cfg = configs.get_reduced(arch)
    gpu = transformer.LMModel.build(cfg, device=cuda)
    cpu = transformer.LMModel(cfg, _cpu_tree(gpu.tree()))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 15))
    absorb = cfg.attention == "mla"
    _build.reset_launches()
    outs = []
    for model, dev in ((gpu, cuda), (cpu, torch.device("cpu"))):
        mesh = make_test_mesh((2, 4), device=dev)
        pre, dec = (lm_policy(cfg, mesh, kind=k, batch=2) for k in ("prefill", "decode"))
        t = torch.as_tensor(toks, device=dev)
        with torch.inference_mode():
            last, cache = transformer.lm_prefill(model, t[:, :12], cfg, pre, max_len=15)
            steps = [transformer.lm_decode_step(model, cache, t[:, i:i + 1], i, cfg, dec,
                                                mla_absorb=absorb)[0] for i in range(12, 15)]
        outs.append((last, torch.cat(steps, 1)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


def test_mla_absorbed_decode_on_card_equals_naive(cuda):
    """deepseek-v3 REDUCED (f32), TF32 off: a 12-token prefill, then 6
    decode steps fed the same tokens through two caches, naive and
    absorbed: every step's logits equal, and equal the full forward's,
    rtol / atol 1e-4; the two latent caches equal at 1e-5."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train.train_step import make_prefill_step

    cfg = configs.get_reduced("deepseek-v3-671b")
    model = transformer.LMModel.build(cfg, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 18)),
                           device=cuda)
    prefill = make_prefill_step(cfg, max_len=18)
    logits = {}
    caches = {}
    for absorb in (False, True):
        _, cache = prefill(model, toks[:, :12])
        with torch.inference_mode():
            logits[absorb] = torch.cat([transformer.lm_decode_step(
                model, cache, toks[:, t:t + 1], t, cfg, mla_absorb=absorb)[0]
                for t in range(12, 18)], 1)
        caches[absorb] = cache
    with torch.inference_mode():
        full = model(toks)[:, 12:]
    for absorb in (False, True):
        np.testing.assert_allclose(logits[absorb].cpu().numpy(), full.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits[True].cpu().numpy(), logits[False].cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    for stack in caches[False]:
        for name, a in caches[False][stack].items():
            np.testing.assert_allclose(caches[True][stack][name].cpu().numpy(),
                                       a.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """REDUCED (f32), TF32 off: 3 AdamW(3e-4) steps of the ``lm`` family on
    the card and on the CPU from the same weights and batches; losses rtol
    1e-5; no kernel launched."""
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.train_step import make_train_step

    cfg = configs.get_reduced(arch)
    opt = opt_lib.adamw(3e-4)
    step = make_train_step(cfg, "lm", opt)
    p_gpu = transformer.LMModel.build(cfg, device=cuda).tree()
    p_cpu = _cpu_tree(p_gpu)
    s_gpu, s_cpu = opt.init(p_gpu), opt.init(p_cpu)
    rng = np.random.default_rng(6)
    _build.reset_launches()
    for _ in range(3):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
        p_gpu, s_gpu, m_gpu = step(p_gpu, s_gpu, {"tokens": toks.to(cuda)})
        p_cpu, s_cpu, m_cpu = step(p_cpu, s_cpu, {"tokens": toks})
        assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-5)
    torch.cuda.synchronize()
    assert not any(_build.launches().values())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b"])
def test_lm_gradients_under_a_mesh_on_card(cuda, arch, remat):
    """REDUCED (f32), capacity E / k so nothing drops, TF32 off: every
    gradient of ``lm_loss`` under ``lm_policy`` on a (2, 4) mesh of ranks
    on the card (its MoE layers expert-parallel, gradients through
    ``shard_map``) against the card without the mesh and against the same
    mesh on the CPU, rtol / atol 1e-5; no kernel launched."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.train_step import value_and_grad

    base = configs.get_reduced(arch)
    cfg = dataclasses.replace(base, remat=remat,
                              capacity_factor=base.num_experts / base.num_experts_per_tok)
    gpu = transformer.LMModel.build(cfg, device=cuda).tree()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 16))
    _build.reset_launches()
    grads = []
    for params, dev, mesh in ((gpu, cuda, (2, 4)), (gpu, cuda, None),
                              (_cpu_tree(gpu), torch.device("cpu"), (2, 4))):
        dctx = None if mesh is None else lm_policy(cfg, make_test_mesh(mesh, device=dev),
                                                   batch=4)
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        grads.append(value_and_grad(transformer.lm_loss, params, batch, cfg, dctx)[0])
    torch.cuda.synchronize()
    assert not any(_build.launches().values())
    for (path, a), b, c in zip(tree_lib.paths(grads[0]), tree_lib.leaves(grads[1]),
                               tree_lib.leaves(grads[2])):
        assert a.device.type == cuda.type
        for ref in (b, c):
            np.testing.assert_allclose(a.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=path)


@pytest.mark.parametrize("kind", ["psum", "all_gather"])
def test_collective_gradcheck_on_card(cuda, kind):
    """``psum`` over both axes and a stacked ``all_gather`` inside
    ``shard_map`` on a (2, 2) mesh of the card pass ``gradcheck`` in f64."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P
    from repro_torch.launch.mesh import make_test_mesh

    def f(x):
        y = torch.tanh(x)
        z = (sharding.psum(y, ("data", "model")) if kind == "psum"
             else sharding.all_gather(y, "model", axis=0, tiled=False))
        return torch.sin(z) * (1.0 + sharding.axis_index("model"))

    mesh = make_test_mesh((2, 2), device=cuda)
    out_spec = P("data", "model") if kind == "psum" else P(None, "data")
    fn = sharding.shard_map(f, mesh=mesh, in_specs=(P("data", "model"),), out_specs=out_spec)
    x = torch.randn(4, 6, dtype=torch.float64, device=cuda, requires_grad=True)
    assert torch.autograd.gradcheck(fn, (x,))


def test_restore_onto_a_card_mesh(cuda, tmp_path):
    """A checkpoint written from the CPU restores under a (2, 4) card
    mesh's ``shard_w`` specs: every leaf on the card, bit-equal."""
    from repro_torch import configs
    from repro_torch.dist.sharding import lm_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.train import checkpoint
    from repro_torch.train import tree as tree_lib

    cfg = configs.get_reduced("qwen3-moe-235b-a22b")
    params = transformer.LMModel.build(cfg, device="cpu").tree()
    checkpoint.save(str(tmp_path), 1, params)
    mesh = make_test_mesh((2, 4), device=cuda)
    specs = lm_policy(cfg, mesh, fsdp=True).shard_w(transformer.lm_decls(cfg))
    got, _ = checkpoint.restore(str(tmp_path), params, shardings=specs, mesh=mesh)
    for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(params)):
        assert a.device == mesh.device and torch.equal(a.cpu(), b)
