"""The beam's level-loop kernel (``kernels/beam``, ``csrc/beam.cu``).

On the CPU: the wrapper's checks raise before any launch, no plan size is
refused, and CPU tensors take the plain version (``core/vptree.beam_levels``).
On a card (``-m gpu``, the ``cuda`` fixture skips without one): the kernel
against the plain version run on the same card, at the b512 cells' shapes
(B 512, d 32, W 16, Bcap 32, K 256, a tree over 60 000 seeded rows), at a
small K where tau is finite and the rules prune, in rows mode with a
``valid`` mask and odd W / Bcap, at a filtered search's widened K, with
no budget over more than 4 096 buckets, and where a block's state passes
shared memory.  ``buf``, ``c_trav`` and ``c_cent`` are equal; ``best_i``
equal except on near ties; distances at the repo's f32 contract (rtol 1e-5
/ atol 5e-4).  Whether the distances are also bit-equal (the kernel sums
in the order of ATen's CUDA reduction as read off one torch build) is
reported by ``tools/profile_beam.py``, not asserted.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import filter as filter_lib
from repro_torch.core import vptree
from repro_torch.kernels import _build
from repro_torch.kernels.beam import beam as beam_mod
from torch_parity import assert_same_ids


def _tree(n, d, *, seed, leaf_size, vectors=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    tree = vptree.build_vptree(X, seed=seed, device="cpu")
    flat = vptree.flatten_vptree(tree, leaf_size=leaf_size, Z=X if vectors else None)
    return X, flat


def _to(flat, dev):
    return flat._replace(**{f: getattr(flat, f).to(dev) for f in flat._fields
                            if isinstance(getattr(flat, f), torch.Tensor)})


def _inputs(n=400, d=8, b=6, seed=1):
    X, flat = _tree(n, d, seed=seed, leaf_size=8)
    Q = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(b, d)).astype(np.float32))
    return flat, Q, torch.as_tensor(X[flat.perm.numpy()])


KW = dict(q=math.inf, k=5, beam_width=4, bucket_cap=3)


# ---------------------------------------------------------------------------
# on the CPU: the checks, and the plain version's path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,value", [
    ("beam_width", 0), ("k", 0), ("bucket_cap", 0), ("q", 0.5), ("q", math.nan),
], ids=["w0", "k0", "bcap0", "q0.5", "qnan"])
def test_the_wrapper_refuses_a_plan_outside_its_limits(knob, value):
    flat, Q, Xf = _inputs()
    before = _build.launches()
    with pytest.raises(ValueError, match="the beam kernel takes beam_width, k and bucket_cap >= 1"):
        beam_mod.beam_cuda(flat, Q, X=Xf, **{**KW, knob: value})
    assert _build.launches() == before


@pytest.mark.parametrize("knob,value", [
    ("beam_width", 65), ("beam_width", 300), ("k", 4097), ("k", 32768),
    ("bucket_cap", 4097), ("bucket_cap", 70000),
], ids=["w65", "w300", "k4097", "k32768", "bcap4097", "bcap70000"])
def test_the_wrapper_takes_a_plan_of_any_size(knob, value):
    """No size is refused: the checks pass, and only the CPU tensors are."""
    flat, Q, Xf = _inputs()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        beam_mod.beam_cuda(flat, Q, X=Xf, **{**KW, knob: value})


def test_the_wrapper_takes_wide_rows_and_refuses_other_metrics():
    flat, Q, Xf = _inputs(d=257)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        beam_mod.beam_cuda(flat, Q, X=Xf, **KW)
    flat, Q, Xf = _inputs()
    with pytest.raises(ValueError, match="got metric 'manhattan'"):
        beam_mod.beam_cuda(flat, Q, X=Xf, metric="manhattan", **KW)


@pytest.mark.parametrize("fault", ["queries_f64", "x_f64", "child_i64", "perm_i64",
                                   "mu_f64", "valid_f32", "queries_strided",
                                   "x_strided", "queries_1d", "dim_mismatch",
                                   "rows_width", "no_centroids", "nodes_mismatch"])
def test_the_wrapper_checks_dtype_shape_and_contiguity(fault):
    flat, Q, Xf = _inputs()
    valid = None
    kw = dict(KW)
    if fault == "queries_f64":
        Q, match = Q.double(), "queries must be torch.float32"
    elif fault == "x_f64":
        Xf, match = Xf.double(), "X must be torch.float32"
    elif fault == "child_i64":
        flat, match = flat._replace(child_in=flat.child_in.long()), "child_in must be torch.int32"
    elif fault == "perm_i64":
        flat, match = flat._replace(perm=flat.perm.long()), "perm must be torch.int32"
    elif fault == "mu_f64":
        flat, match = flat._replace(mu=flat.mu.double()), "mu must be torch.float32"
    elif fault == "valid_f32":
        valid, match = torch.ones(Xf.shape[0]), "valid must be torch.bool or torch.uint8"
    elif fault == "queries_strided":
        Q, match = torch.cat([Q, Q], 1)[:, ::2], "queries must be contiguous"
    elif fault == "x_strided":
        Xf, match = Xf.t().contiguous().t(), "X must be contiguous"
    elif fault == "queries_1d":
        Q, match = Q[0], "queries must have 2 dimensions"
    elif fault == "dim_mismatch":
        Xf, match = Xf[:, :4].contiguous(), "dimension mismatch"
    elif fault == "rows_width":
        Xf, match = None, r"rows mode takes \(B, n\) rows"
    elif fault == "no_centroids":
        flat, match = flat._replace(centroids=None), "needs the tree's centroids"
    else:
        flat, match = flat._replace(mu=flat.mu[:-1]), "node arrays differ in length"
    before = _build.launches()
    with pytest.raises(ValueError, match=match):
        beam_mod.beam_cuda(flat, Q, X=Xf, valid=valid, **kw)
    assert _build.launches() == before


def test_the_wrapper_refuses_cpu_tensors_after_its_checks():
    flat, Q, Xf = _inputs()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        beam_mod.beam_cuda(flat, Q, X=Xf, **KW)


@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
@pytest.mark.parametrize("mode", ["vector", "rows"])
def test_cpu_tensors_take_the_plain_version(q, mode, monkeypatch):
    """``search_beam`` on CPU tensors runs ``beam_levels`` and never the
    kernel's wrapper; the plain loop's outputs keep their shapes and
    dtypes."""
    flat, Q, Xf = _inputs()
    if mode == "rows":
        Q = torch.cdist(Q, Xf)[:, torch.argsort(flat.perm.long())].contiguous()
        Xf = None
    kw = dict(q=q, k=5, beam_width=4, bucket_cap=3, X=Xf)

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(beam_mod, "beam_cuda", refuse)
    before = _build.launches()
    idx, dist, comps = vptree.search_beam(flat, Q, **kw)
    assert _build.launches() == before
    assert idx.shape == dist.shape == (Q.shape[0], 5) and (comps > 0).all()
    best_d, best_i, buf, c_trav, c_cent = vptree.beam_levels(flat, Q, **kw)
    assert best_d.shape == best_i.shape == (Q.shape[0], 5) and buf.shape == (Q.shape[0], 3)
    assert best_i.dtype == buf.dtype == c_trav.dtype == c_cent.dtype == torch.int64
    assert (c_trav > 0).all() and ((c_cent > 0).all() if mode == "vector" else (c_cent == 0).all())


@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_the_plain_lists_hold_at_most_a_levels_reach(q):
    """What lets the kernel hold min(K, W * depth) of the best list and
    min(Bcap, 2W * depth) of the buffer: past those the plain version's
    entries are (+inf, -1), and its K-th distance is +inf."""
    flat, Q, Xf = _inputs(n=600)
    W = 2
    reach = W * flat.depth
    best_d, best_i, buf, c_trav, _ = vptree.beam_levels(
        flat, Q, X=Xf, q=q, k=reach + 40, beam_width=W, bucket_cap=2 * reach + 40)
    assert (torch.isfinite(best_d).sum(1) <= reach).all()
    assert torch.isinf(best_d[:, reach:]).all() and (best_i[:, reach:] == -1).all()
    assert ((buf >= 0).sum(1) <= 2 * reach).all() and (buf[:, 2 * reach:] == -1).all()
    assert (c_trav <= reach).all()


def test_no_plan_the_search_makes_is_refused():
    """The plans ``beam_plan`` makes with and without a budget, over trees
    of up to 10^6 rows, and the filtered search's widened K at selectivity
    0.01, all pass the wrapper's checks."""
    flat, Q, Xf = _inputs()
    for nodes, buckets in [(7, 8), (4095, 4096), (60000, 4096), (65535, 65536)]:
        for budget in (None, 64, 1024, 10 ** 6):
            W, Bcap = vptree.beam_plan(budget, depth=16, leaf_size=16, num_nodes=nodes,
                                       num_buckets=buckets, k=256)
            for k in (256, filter_lib.scaled_width(256, 0.01, 10 ** 6)):
                with pytest.raises(ValueError, match="takes CUDA tensors"):
                    beam_mod.beam_cuda(flat, Q, X=Xf, q=math.inf, k=k, beam_width=W,
                                       bucket_cap=Bcap)


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


def _parity(flat, Q, dev, *, X=None, valid=None, **kw):
    """The kernel against the plain version on the card: ``buf`` and the
    counters equal, ids equal except on near ties, distances at the f32
    contract."""
    flat = _to(flat, dev)
    Q = Q.to(dev)
    X = None if X is None else X.to(dev)
    valid = None if valid is None else valid.to(dev)
    before = _build.launches()["beam/levels"]
    got = beam_mod.beam_cuda(flat, Q, X=X, valid=valid, **kw)
    torch.cuda.synchronize()
    assert _build.launches()["beam/levels"] == before + 1
    want = vptree.beam_levels(flat, Q, X=X, valid=valid, **kw)
    (bd, bi, buf, ct, cc), (rbd, rbi, rbuf, rct, rcc) = got, want
    assert bd.shape == rbd.shape and buf.shape == rbuf.shape
    assert torch.equal(buf, rbuf)
    assert torch.equal(ct, rct) and torch.equal(cc, rcc)
    assert_same_ids(bi, bd, rbi, rbd)
    return got, want


@pytest.fixture(scope="module")
def cell_tree():
    """A tree over 60 000 seeded rows of d = 32 (the cells' Phi width), leaf
    size 16, and 512 queries near them."""
    X, flat = _tree(60000, 32, seed=5, leaf_size=16)
    rng = np.random.default_rng(6)
    Q = X[rng.choice(60000, 512, replace=False)] + 0.1 * rng.normal(size=(512, 32))
    return flat, torch.as_tensor(Q.astype(np.float32)), torch.as_tensor(X[flat.perm.numpy()])


@pytest.mark.gpu
@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_kernel_matches_plain_at_the_cells_shapes(cuda, cell_tree, q):
    flat, Q, Xf = cell_tree
    W, Bcap = vptree.beam_plan(1024, depth=flat.depth, leaf_size=flat.leaf_size,
                               num_nodes=flat.num_nodes, num_buckets=flat.num_buckets, k=256)
    assert (W, Bcap) == (16, 32)
    (_, _, buf, ct, cc), _ = _parity(flat, Q, cuda, X=Xf, q=q, k=256, beam_width=W,
                                     bucket_cap=Bcap)
    assert (buf >= 0).all() and (ct > 100).all() and (cc > 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("q", [math.inf, 2.0, 4.0], ids=["qinf", "q2", "q4"])
def test_kernel_matches_plain_where_the_rules_prune(cuda, q):
    """K = 5 in 6 dimensions: tau turns finite after five vantages, and the
    rules drop children at every q (as ``tests/test_torch_beam_prune.py``
    shows on the CPU), so the buckets reached differ from K = 2 048's."""
    X, flat = _tree(3000, 6, seed=7, leaf_size=8)
    Q = torch.as_tensor(np.random.default_rng(8).normal(size=(256, 6)).astype(np.float32))
    Xf = torch.as_tensor(X[flat.perm.numpy()])
    _parity(flat, Q, cuda, X=Xf, q=q, k=5, beam_width=16, bucket_cap=12)
    wide = vptree.beam_levels(flat, Q, X=Xf, q=q, k=2048, beam_width=16, bucket_cap=12)
    narrow = vptree.beam_levels(flat, Q, X=Xf, q=q, k=5, beam_width=16, bucket_cap=12)
    assert (wide[2] != narrow[2]).any(1).float().mean() > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("d", [5, 100, 132])
@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_kernel_matches_plain_at_other_widths(cuda, q, d):
    """Row widths that take the distance sum's other lane layouts: fewer
    than 32 lanes, several columns a lane, and the 4-column loads past 128
    columns."""
    X, flat = _tree(3000, d, seed=9, leaf_size=8)
    Q = torch.as_tensor(np.random.default_rng(10).normal(size=(256, d)).astype(np.float32))
    _parity(flat, Q, cuda, X=torch.as_tensor(X[flat.perm.numpy()]), q=q, k=5,
            beam_width=16, bucket_cap=12)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [math.inf, 2.0, 4.0], ids=["qinf", "q2", "q4"])
@pytest.mark.parametrize("filtered", [False, True], ids=["all", "valid"])
def test_kernel_matches_plain_in_rows_mode_with_odd_knobs(cuda, q, filtered):
    X, flat = _tree(250, 5, seed=10, leaf_size=4, vectors=False)
    Q = np.random.default_rng(11).normal(size=(40, 5)).astype(np.float32)
    rows = torch.cdist(torch.as_tensor(Q).double(), torch.as_tensor(X).double()).float()
    valid = torch.as_tensor(np.arange(250) % 5 != 0) if filtered else None
    _parity(flat, rows, cuda, valid=valid, q=q, k=6, beam_width=3, bucket_cap=5)


@pytest.mark.gpu
def test_kernel_matches_plain_with_a_valid_mask_in_vector_mode(cuda, cell_tree):
    flat, Q, Xf = cell_tree
    valid = torch.as_tensor(np.random.default_rng(12).random(60000) < 0.3)
    _parity(flat, Q[:128], cuda, X=Xf, valid=valid, q=math.inf, k=64, beam_width=16,
            bucket_cap=32)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_kernel_matches_plain_at_a_filtered_searchs_width(cuda, cell_tree, q):
    """A filter passing 1 % of the rows at rerank 256: the infinity engine
    widens K to ``scaled_width`` (32 768 here), past what a level loop can
    fill, so the kernel holds W * depth entries and pads the rest."""
    flat, Q, Xf = cell_tree
    valid = torch.as_tensor(np.random.default_rng(15).random(60000) < 0.01)
    sel = filter_lib.bucket_selectivity(float(valid.float().mean()))
    K = filter_lib.scaled_width(256, sel, 60000)
    assert K == 32768 and K > 16 * flat.depth
    (bd, bi, _, _, _), _ = _parity(flat, Q, cuda, X=Xf, valid=valid, q=q, k=K,
                                   beam_width=16, bucket_cap=32)
    assert torch.isfinite(bd).any() and torch.isinf(bd[:, 16 * flat.depth:]).all()
    assert bool(valid.to(cuda)[bi[bi >= 0]].all())


@pytest.mark.gpu
def test_kernel_matches_plain_with_no_budget_over_many_buckets(cuda):
    """No budget over 80 000 rows at leaf size 16: ``beam_plan`` gives W 64
    and Bcap = every bucket (more than 4 096)."""
    X, flat = _tree(80000, 32, seed=16, leaf_size=16)
    rng = np.random.default_rng(17)
    Q = torch.as_tensor((X[rng.choice(80000, 64, replace=False)]
                         + 0.1 * rng.normal(size=(64, 32))).astype(np.float32))
    W, Bcap = vptree.beam_plan(None, depth=flat.depth, leaf_size=flat.leaf_size,
                               num_nodes=flat.num_nodes, num_buckets=flat.num_buckets, k=256)
    assert W == 64 and Bcap == flat.num_buckets > 4096
    (_, _, buf, _, cc), _ = _parity(flat, Q, cuda, X=torch.as_tensor(X[flat.perm.numpy()]),
                                    q=math.inf, k=256, beam_width=W, bucket_cap=Bcap)
    assert (cc > W).all() and ((buf >= 0).sum(1) == cc).all()


@pytest.mark.gpu
@pytest.mark.parametrize("W,K,Bcap,where", [(100, 4096, 4096, "optin"),
                                             (400, 8192, 8192, "global")],
                         ids=["optin", "global"])
@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_kernel_past_shared_memory(cuda, q, W, K, Bcap, where):
    """d 256 and large plans: a block's state past the default 48 KB of
    shared memory (W 100), and past the card's shared memory a block (W 400,
    more children than the block has threads), where it lives in global
    scratch."""
    X, flat = _tree(20000, 256, seed=13, leaf_size=4)
    Q = torch.as_tensor(np.random.default_rng(14).normal(size=(8, 256)).astype(np.float32))
    Xf = torch.as_tensor(X[flat.perm.numpy()])
    reach = W * flat.depth
    state = 4 * (256 + 4 * min(K, reach) + 4 * min(Bcap, 2 * reach) + 24 * W)
    optin = getattr(torch.cuda.get_device_properties(cuda), "shared_memory_per_block_optin",
                    227 * 1024)  # an H100's
    assert (48 * 1024 < state <= optin) if where == "optin" else state > optin
    _parity(flat, Q, cuda, X=Xf, q=q, k=K, beam_width=W, bucket_cap=Bcap)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [math.inf, 2.0], ids=["qinf", "q2"])
def test_search_beam_on_the_card_launches_the_kernel_once(cuda, cell_tree, q):
    """``search_beam`` on the card: one ``beam/levels`` launch a call, and the
    same answers as the plain loop (monkeypatched in) on the card."""
    flat, Q, Xf = cell_tree
    flat, Q, Xf = _to(flat, cuda), Q.to(cuda), Xf.to(cuda)
    kw = dict(q=q, k=256, X=Xf, max_comparisons=1024, with_stages=True)
    before = _build.launches()["beam/levels"]
    got = vptree.search_beam(flat, Q, **kw)
    assert _build.launches()["beam/levels"] == before + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(beam_mod, "beam_cuda", vptree.beam_levels)
        want = vptree.search_beam(flat, Q, **kw)
    assert _build.launches()["beam/levels"] == before + 1
    assert_same_ids(got[0], got[1], want[0], want[1])
    assert torch.equal(got[2], want[2])
    for stage in want[3]:
        assert torch.equal(got[3][stage], want[3][stage])
