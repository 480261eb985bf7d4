"""The embedding-bag kernel's launch plan (``kernels/bag/bag.py:launch_plan``)
held to its contract on the CPU: the kernel's own index arithmetic
(``csrc/bag.cu:bag_kernel``), mirrored in numpy, covers every output
(b, d) exactly once and every s in ascending order, the staged tile fits
the shared memory the plan asks for, and a small batch spreads over the
card.  No card is needed: the plan is plain Python."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.bag import bag as bag_mod  # noqa: E402
from repro_torch.kernels.bag.bag import (  # noqa: E402
    CHUNKS, MAX_THREADS, SMEM_BYTES, WARP, launch_plan, staged_words, thread_plan,
)

SMS = 132  # an H100 SXM


def _owners(plan, B, D):
    """(b, d) of every output the kernel writes, by its own index
    arithmetic.  ``bag_kernel``: block k owns bags [k * bags, k * bags +
    rows), and thread t of pass p the output e = p * threads + t < rows * D,
    i.e. (b0 + e // D, e % D).  ``bag_warp_kernel``: warp w of block k owns
    bag k * bags + w < B, and lane l the columns l, l + 32, ... < D."""
    blocks = -(-B // plan.bags)
    if plan.warp:
        assert plan.bags == plan.threads // WARP
        b = np.arange(blocks * plan.bags, dtype=np.int64)[:, None]
        d = np.arange(-(-D // WARP) * WARP, dtype=np.int64)[None, :]
        b, d = np.broadcast_arrays(b, d)
        keep = (b < B) & (d < D)
        return b[keep], d[keep]
    b0 = np.arange(blocks, dtype=np.int64) * plan.bags
    rows = np.minimum(plan.bags, B - b0)
    passes = -(-(plan.bags * D) // plan.threads)
    e = np.arange(passes * plan.threads, dtype=np.int64)
    active = e[None, :] < (rows * D)[:, None]
    b = b0[:, None] + e[None, :] // D
    d = np.broadcast_to(e[None, :] % D, b.shape)
    return b[active], d[active]


def _fold_order(plan, S):
    """The s each output folds, in order.  ``bag_kernel``: windows of
    ``window`` ids, each in chunks of ``chunk`` with the chunk's tail past
    the window skipped; ``bag_warp_kernel``: s = 0 .. S - 1 from its slots."""
    if plan.warp:
        return list(range(S))
    order = []
    for lo in range(0, S, plan.window):
        n = min(plan.window, S - lo)
        for c in range(0, n, plan.chunk):
            order += [lo + c + j for j in range(plan.chunk) if c + j < n]
    return order


@pytest.mark.parametrize("D", [1, 10, 16])
@pytest.mark.parametrize("S", [1, 7, 39, 100])
@pytest.mark.parametrize("B", [1, 32, 512, 262144])
def test_launch_plan_contract(B, S, D):
    """The plan ``launch_plan`` picks, and the thread path's plan wherever
    it picks the warp path (what the profile tool forces)."""
    plans = [(weighted, launch_plan(B, S, D, SMS, weighted=weighted))
             for weighted in (False, True)]
    plans += [(weighted, thread_plan(B, S, D, SMS, weighted=weighted))
              for weighted, plan in plans if plan.warp]
    for weighted, plan in plans:
        # what bag_f32 takes
        assert plan.threads % WARP == 0 and WARP <= plan.threads <= MAX_THREADS
        assert plan.bags >= 1
        assert plan.window == S or (plan.bags == 1 and 1 <= plan.window < S)
        # the staged ids (and weights, and on the warp path the gathered
        # values) fit what the plan asks for, and that fits the budget
        if plan.warp:
            assert plan.chunk == S and plan.bags == plan.threads // WARP
            assert plan.smem_bytes == 4 * S * (D + 2) * plan.bags
        else:
            assert plan.chunk in CHUNKS
            arrays = 2 if weighted else 1
            assert plan.smem_bytes == 4 * staged_words(plan.bags * plan.window) * arrays
        assert plan.smem_bytes <= SMEM_BYTES
        # every (b, d) exactly once
        b, d = _owners(plan, B, D)
        counts = np.bincount(b * D + d, minlength=B * D)
        assert counts.shape == (B * D,) and (counts == 1).all()
        # s ascending, each once
        assert _fold_order(plan, S) == list(range(S))


@pytest.mark.parametrize("S", [39, 7])
def test_launch_plan_spreads_small_batches(S):
    """serve_p99's 512 bags at D = 1 reach at least 16 SMs, one warp a bag
    with every gather in flight at once; a batch that fills the card takes
    full blocks of one thread an output, a whole bag's gathers (S <= 40)
    one chunk."""
    plan = launch_plan(512, S, 1, SMS)
    assert -(-512 // plan.bags) >= 16 and plan.warp
    full = launch_plan(262144, S, 1, SMS)
    assert full.threads == MAX_THREADS and not full.warp and full.chunk >= S


@pytest.mark.parametrize("weighted", [False, True])
def test_launch_plan_windows_one_bag_past_the_budget(weighted):
    """A bag whose ids alone pass the shared-memory budget takes the thread
    path and is staged a window at a time, one bag a block, every s still
    folded in order and every output once."""
    S = SMEM_BYTES // 4 + 5
    for B, D in ((3, 2), (5000, 16)):
        plan = launch_plan(B, S, D, SMS, weighted=weighted)
        assert not plan.warp and plan.bags == 1 and plan.window < S
        assert plan.smem_bytes <= SMEM_BYTES
        assert _fold_order(plan, S) == list(range(S))
        b, d = _owners(plan, B, D)
        assert (np.bincount(b * D + d, minlength=B * D) == 1).all()
    assert bag_mod.staged_words(1) == 4 and bag_mod.staged_words(2) == 8
