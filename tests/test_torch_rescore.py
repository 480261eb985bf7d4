"""The exact re-score kernel (``kernels/rescore``, ``csrc/rescore.cu``) behind
``core/scan.topk_candidates``.

On the CPU: CPU tensors take the plain version, correlation and jaccard
have no kernel, the wrapper's checks raise before any launch, and the
kernel's counted work.  On a card (``-m gpu``, the ``cuda`` fixture skips
without one): the kernel against the plain version run on the same card,
at the cells' shapes (512 x 4 096 from 60 000 x 784 with ~5 % -1, and
512 x 256), at k = 1, k = C and C < k, with a row of -1 only, duplicate
rows (ties to the earlier position), d = 49 and d = 100 off 16-byte
alignment, every metric of ``SUPPORTED``, and past the shared memory's
distances and survivors.  Ids equal except on near ties, distances at the
repo's f32 contract (rtol 1e-5 / atol 5e-4): the kernel sums in another
order than ATen.  A query's answer is bit-equal alone and in a batch; one
launch a call, and one a batch on the live and infinity serving paths.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import scan as scan_lib
from repro_torch.dist import roofline
from repro_torch.kernels import _build
from repro_torch.kernels.rescore import rescore as rescore_mod
from repro_torch.kernels.topk import ops as topk_ops
from torch_parity import assert_same_ids


def _inputs(B=6, C=40, n=300, d=12, seed=0, dtype=torch.int64, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    Q = torch.randn((B, d), generator=g)
    X = torch.randn((n, d), generator=g)
    cand = torch.randint(-1, n, (B, C), generator=g).to(dtype)
    return Q.to(device), cand.to(device), X.to(device)


# ---------------------------------------------------------------------------
# on the CPU: the dispatch, the checks, the work
# ---------------------------------------------------------------------------

def test_the_kernel_covers_the_topk_kernels_metrics():
    assert set(rescore_mod.SUPPORTED) == set(topk_ops.SUPPORTED)
    assert "correlation" not in rescore_mod.SUPPORTED
    assert "jaccard" not in rescore_mod.SUPPORTED


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine", "dot", "manhattan",
                                    "chebyshev", "correlation", "jaccard"])
def test_cpu_tensors_take_the_plain_version(metric, monkeypatch):
    """On the CPU every metric goes through the plain gather, pair form and
    stable sort; the kernel's wrapper never runs."""
    Q, cand, X = _inputs()

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(rescore_mod, "rescore_cuda", refuse)
    before = _build.launches()
    idx, dist = scan_lib.topk_candidates(Q, cand, X, k=5, metric=metric)
    assert _build.launches() == before
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert idx.shape == dist.shape == (6, 5)
    assert (dist[:, 1:] >= dist[:, :-1]).all()
    assert torch.equal(idx == -1, torch.isinf(dist))


def test_the_plain_version_keeps_ties_in_position_order():
    """Duplicate rows score equal: the earlier candidate position comes
    first, whatever the ids."""
    X = torch.randn((4, 8))
    X = torch.cat([X, X, X])  # rows i, i + 4, i + 8 are one vector
    Q = torch.randn((2, 8))
    cand = torch.tensor([[8, 4, 0, 9, 5, 1], [1, 5, 9, 0, 4, 8]])
    idx, dist = scan_lib.topk_candidates(Q, cand, X, k=6, metric="euclidean")
    assert int((dist[:, 1:] == dist[:, :-1]).sum()) == 8
    for row in range(2):
        pos = [cand[row].tolist().index(int(i)) for i in idx[row]]
        for a in range(5):
            if dist[row, a] == dist[row, a + 1]:
                assert pos[a] < pos[a + 1]


def test_the_plain_version_pads_short_and_empty_lists():
    Q, cand, X = _inputs(B=3, C=4)
    cand[1] = -1
    idx, dist = scan_lib.topk_candidates(Q, cand, X, k=7, metric="sqeuclidean")
    assert idx.shape == (3, 7)
    assert (idx[:, 4:] == -1).all() and torch.isinf(dist[:, 4:]).all()
    assert (idx[1] == -1).all() and torch.isinf(dist[1]).all()


@pytest.mark.parametrize("metric", ["euclidean", "correlation"])
def test_ids_past_the_corpus_are_no_candidates(metric):
    """An id >= n scores +inf and reads no row, as -1 does: the answer is
    that of the same lists with those ids set to -1."""
    Q, cand, X = _inputs(B=4, C=30, n=200)
    bad = cand.clone()
    bad[:, ::3] = torch.tensor([200, 201, 10 ** 6, 2 ** 40]).repeat(4, 3)[:, :10]
    none = torch.where(bad >= 200, -1, bad)
    got = scan_lib.topk_candidates(Q, bad, X, k=30, metric=metric)
    want = scan_lib.topk_candidates(Q, none, X, k=30, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] >= 0).sum()) == int((none >= 0).sum())


def _fault(name):
    Q, cand, X = _inputs()
    kw = dict(k=5, metric="euclidean")
    match = {
        "q_f64": "Q must be torch.float32", "x_f64": "X must be torch.float32",
        "cand_f32": "cand must be torch.int32 or torch.int64",
        "cand_i16": "cand must be torch.int32 or torch.int64",
        "q_strided": "Q must be contiguous", "x_strided": "X must be contiguous",
        "cand_strided": "cand must be contiguous", "q_1d": "Q must have 2 dimensions",
        "x_device": "X is on meta", "cand_device": "cand is on meta",
        "rows_mismatch": "shape mismatch", "dim_mismatch": "shape mismatch",
        "metric": "got metric 'correlation'", "k0": "takes k >= 1",
        "too_wide": "takes 1 <= d <= 16384", "cpu": "takes CUDA tensors",
    }[name]
    if name == "q_f64":
        Q = Q.double()
    elif name == "x_f64":
        X = X.double()
    elif name == "cand_f32":
        cand = cand.float()
    elif name == "cand_i16":
        cand = cand.to(torch.int16)
    elif name == "q_strided":
        Q = torch.cat([Q, Q], 1)[:, ::2]
    elif name == "x_strided":
        X = X.t().contiguous().t()
    elif name == "cand_strided":
        cand = torch.cat([cand, cand], 1)[:, ::2]
    elif name == "q_1d":
        Q = Q[0]
    elif name == "x_device":
        X = X.to("meta")
    elif name == "cand_device":
        cand = cand.to("meta")
    elif name == "rows_mismatch":
        cand = cand[:-1].contiguous()
    elif name == "dim_mismatch":
        X = X[:, :5].contiguous()
    elif name == "metric":
        kw["metric"] = "correlation"
    elif name == "k0":
        kw["k"] = 0
    elif name == "too_wide":
        Q, X = torch.zeros((6, 16385)), torch.zeros((300, 16385))
    return (Q, cand, X), kw, match


@pytest.mark.parametrize("name", ["q_f64", "x_f64", "cand_f32", "cand_i16", "q_strided",
                                  "x_strided", "cand_strided", "q_1d", "x_device",
                                  "cand_device", "rows_mismatch", "dim_mismatch", "metric",
                                  "k0", "too_wide", "cpu"])
def test_the_wrapper_checks_before_any_launch(name):
    """A wrong dtype, device, shape or layout, a metric without a kernel,
    k < 1 or a query row past shared memory raise, and CPU tensors raise
    after every check; nothing is launched or counted."""
    args, kw, match = _fault(name)
    before = _build.launches()
    with pytest.raises(ValueError, match=match):
        rescore_mod.rescore_cuda(*args, **kw)
    assert _build.launches() == before


@pytest.mark.parametrize("k", [1, 10, 4096, 5000])
def test_the_wrapper_takes_any_k(k):
    """Every k >= 1 passes the checks, k past C included; only the CPU
    tensors are refused."""
    Q, cand, X = _inputs(C=4096)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        rescore_mod.rescore_cuda(Q, cand, X, k=k, metric="euclidean")


def test_the_kernels_work_counts_each_alive_row_once():
    """Four alive candidates scored; three distinct rows read (row 3 is
    named twice)."""
    cand = torch.tensor([[3, -1, 5, 3], [-1, -1, -1, 0]])
    ops, kind, nbytes = roofline.rescore_work(cand, 784, 10)
    assert kind == "f32_instr"
    assert ops == 2 * 4 * 784
    assert nbytes == 4 * 3 * 784 + 4 * 2 * 784 + 8 * 8 + 8 * 2 * 10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _plain(Q, cand, X, *, k, metric):
    """The plain version on the same card."""
    return scan_lib._plain_candidates(Q, cand, X, k=k, metric=metric)


def _parity(Q, cand, X, *, k, metric="euclidean"):
    before = _build.launches()["rescore"]
    got = scan_lib.topk_candidates(Q, cand, X, k=k, metric=metric)
    torch.cuda.synchronize()
    assert _build.launches()["rescore"] == before + 1
    want = _plain(Q, cand, X, k=k, metric=metric)
    assert got[0].shape == want[0].shape == (Q.shape[0], k)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert torch.equal(got[0] == -1, torch.isinf(got[1]))
    assert_same_ids(got[0], got[1], want[0], want[1])
    return got, want


def _corpus(n, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, d), generator=g, device=device)


def _lists(X, B, C, *, seed, dead=0.05, near=True):
    """B queries near rows of X and, for each, C distinct candidate ids
    (the nearest C by the plain scan where ``near``, as the live cell's
    oversample; random otherwise), a share ``dead`` of them -1."""
    dev = X.device
    g = torch.Generator(device=dev).manual_seed(seed)
    n = X.shape[0]
    rows = torch.randperm(n, generator=g, device=dev)[:B]
    Q = X[rows] + 0.3 * torch.randn((B, X.shape[1]), generator=g, device=dev)
    if near:
        _, cand = scan_lib.topk_scan(Q, X, k=C, metric="euclidean")
        cand = cand.long()
    else:
        cand = torch.stack([torch.randperm(n, generator=g, device=dev)[:C] for _ in range(B)])
    cand = torch.where(torch.rand(cand.shape, generator=g, device=dev) < dead, -1, cand)
    return Q, cand.contiguous()


@pytest.fixture(scope="module")
def cell_rows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _corpus(60000, 784, torch.device("cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4096, 256], ids=["live", "rerank"])
def test_kernel_matches_plain_at_the_cells_shapes(cuda, cell_rows, C):
    Q, cand = _lists(cell_rows, 512, C, seed=C)
    assert 0.03 < float((cand < 0).float().mean()) < 0.07
    _parity(Q, cand, cell_rows, k=10)
    _parity(Q, cand.int(), cell_rows, k=10)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", rescore_mod.SUPPORTED)
@pytest.mark.parametrize("d", [784, 49, 100])
def test_kernel_matches_plain_for_every_metric(cuda, metric, d):
    X = _corpus(5000, d, cuda, seed=d)
    Q, cand = _lists(X, 96, 700, seed=1, near=False)
    _parity(Q, cand, X, k=10, metric=metric)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [100, 784, 49])
def test_kernel_takes_rows_off_16_byte_alignment(cuda, d):
    """X one float past an aligned base: the 4-byte loads."""
    flat = _corpus(3001, d, cuda, seed=3).reshape(-1)
    X = flat[1:1 + 3000 * d].view(3000, d)
    assert X.data_ptr() % 16 != 0 and X.is_contiguous()
    Q, cand = _lists(X.clone(), 64, 300, seed=2, near=False)
    _parity(Q, cand, X, k=10)


@pytest.mark.gpu
@pytest.mark.parametrize("k,C", [(1, 4096), (256, 256), (4096, 4096), (20, 7), (5000, 4100),
                                 (10, 9000), (9000, 9000)],
                         ids=["k1", "kC", "kC4096", "C<k", "words_past_smem",
                              "dist_past_smem", "both_past_smem"])
def test_kernel_matches_plain_at_any_k(cuda, k, C):
    X = _corpus(20000, 64, cuda, seed=4)
    Q, cand = _lists(X, 24, C, seed=k + C, near=False)
    (idx, dist), _ = _parity(Q, cand, X, k=k)
    if C < k:
        assert (idx[:, C:] == -1).all() and torch.isinf(dist[:, C:]).all()


@pytest.mark.gpu
def test_ids_that_repeat_and_crowd_few_bins(cuda):
    """50 rows under 300-long lists: every id several times in a list, and
    the visiting order's bins each hold one id or none."""
    X = _corpus(50, 24, cuda, seed=10)
    g = torch.Generator(device=cuda).manual_seed(10)
    Q = torch.randn((40, 24), generator=g, device=cuda)
    cand = torch.randint(-1, 50, (40, 300), generator=g, device=cuda)
    _parity(Q, cand, X, k=10)
    _parity(Q, cand, X, k=300)


@pytest.mark.gpu
def test_a_row_of_none_gives_inf_and_minus_one(cuda):
    X = _corpus(2000, 32, cuda, seed=5)
    Q, cand = _lists(X, 8, 100, seed=5, near=False)
    cand[3] = -1
    cand[5, :95] = -1
    (idx, dist), _ = _parity(Q, cand, X, k=10)
    assert (idx[3] == -1).all() and torch.isinf(dist[3]).all()
    assert (idx[5, 5:] == -1).all() and (idx[5, :5] >= 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_ids_past_the_corpus_are_none_on_the_card_too(cuda, dtype):
    """The kernel and the plain version agree on ids >= n: no candidate."""
    X = _corpus(2000, 32, cuda, seed=11)
    Q, cand = _lists(X, 8, 100, seed=11, near=False)
    cand[:, ::4] = 2000 + torch.arange(25, device=cuda) * 7919
    (idx, dist), _ = _parity(Q, cand.to(dtype).contiguous(), X, k=90)
    assert int((idx >= 0).sum()) == int(((cand >= 0) & (cand < 2000)).sum())
    assert (idx < 2000).all()


@pytest.mark.gpu
def test_ties_go_to_the_earlier_position(cuda):
    """Every vector three times under different ids: equal distances, and
    the kernel's order keeps the candidates' positions, as the plain
    version's stable sort does."""
    base = _corpus(400, 50, cuda, seed=6)
    X = torch.cat([base, base, base]).contiguous()
    g = torch.Generator(device=cuda).manual_seed(6)
    Q = base[:32] + 0.5 * torch.randn((32, 50), generator=g, device=cuda)
    cand = torch.stack([torch.randperm(1200, generator=g, device=cuda)[:600]
                        for _ in range(32)])
    (idx, dist), (pidx, pdist) = _parity(Q, cand, X, k=60)
    assert torch.equal(idx, pidx)
    pos = (cand[:, None, :] == idx.long()[:, :, None]).float().argmax(-1)
    tie = dist[:, 1:] == dist[:, :-1]
    assert tie.any()
    assert (pos[:, 1:] > pos[:, :-1])[tie].all()


@pytest.mark.gpu
def test_an_answer_does_not_depend_on_the_batch(cuda, cell_rows):
    Q, cand = _lists(cell_rows, 64, 4096, seed=7)
    idx, dist = scan_lib.topk_candidates(Q, cand, cell_rows, k=10, metric="euclidean")
    for row in (0, 17, 63):
        one = scan_lib.topk_candidates(Q[row:row + 1].contiguous(),
                                       cand[row:row + 1].contiguous(), cell_rows, k=10,
                                       metric="euclidean")
        assert torch.equal(one[0][0], idx[row]) and torch.equal(one[1][0], dist[row])


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["correlation", "jaccard"])
def test_metrics_without_a_kernel_stay_plain_on_the_card(cuda, metric):
    X = (_corpus(1000, 40, cuda, seed=8) > 0).float()
    Q, cand = _lists(X, 16, 200, seed=8, near=False)
    before = _build.launches()
    got = scan_lib.topk_candidates(Q, cand, X, k=10, metric=metric)
    torch.cuda.synchronize()
    assert _build.launches() == before
    want = _plain(Q, cand, X, k=10, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_the_live_and_infinity_serving_paths_launch_it_once_a_batch(cuda):
    """``SearchServer.query`` over a live brute index mid-cycle (rows
    deleted and re-inserted) re-scores its frozen oversample, and over an
    infinity index at a beam batch reranks, each with one launch a batch."""
    from repro_torch.data import synthetic
    from repro_torch.launch.serve import SearchServer

    X = synthetic.make("manifold", 2000, seed=9)
    Q = X[:128]
    live = SearchServer(X, engine="brute", cfg={"metric": "euclidean"}, live=True,
                        delta_cap=200, device=cuda)
    dead = np.arange(100, 200)
    live.delete(dead)
    live.upsert(X[dead])
    inf = SearchServer(X, engine="infinity", cfg={
        "proj_sample": 256, "knn_k": 8, "num_hops": 4, "embed_dim": 16, "hidden": (64,),
        "train_steps": 50, "batch_pairs": 256, "mode": "beam", "budget": 512, "rerank": 32,
    }, device=cuda)
    for server in (live, inf):
        server.query(Q, k=10, record=False)
        torch.cuda.synchronize()
        _build.reset_launches()
        for _ in range(3):
            res = server.query(Q, k=10, record=False)
        torch.cuda.synchronize()
        assert _build.launches()["rescore"] == 3
        assert np.asarray(res.idx).shape == (128, 10)
