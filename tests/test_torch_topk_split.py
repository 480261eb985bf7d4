"""The f32 topk kernel's column splits (``kernels/topk/topk.py:split_plan``),
on the CPU: the plan is pure arithmetic, so its contract is checked here;
the scan and merge it drives are held to their plain version on the card
(``test_torch_cuda.py::test_topk_kernel_splits``)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.topk import topk as topk_mod  # noqa: E402
from repro_torch.kernels.topk.topk import (  # noqa: E402
    MAX_SPLITS, SCRATCH_BYTES, TILE_COLS, rows_per_block, split_plan,
)

# (m, n, k, slots): the main path's shapes (brute batch, kNN graph, ground
# truth, k = 600 batch) at one and two resident blocks per SM, ragged and
# tiny shapes, k past one split's columns and past n
SHAPES = [
    (512, 60000, 10, 264), (512, 60000, 10, 132), (2048, 2048, 16, 264),
    (10000, 60000, 10, 264), (512, 60000, 600, 264), (40, 3000, 600, 132),
    (100, 4096, 200, 132), (33, 257, 5, 264), (1, 1, 1, 264), (6, 10, 25, 264),
    (64, 4096, 10, 264), (130, 129, 17, 264), (7, 1000, 5000, 132),
]


@pytest.mark.parametrize("m,n,k,slots", SHAPES)
def test_split_plan_covers_the_columns_once_in_order(m, n, k, slots):
    plan = split_plan(m, n, k, slots)
    assert 1 <= len(plan) <= MAX_SPLITS
    assert plan[0][0] == 0 and plan[-1][1] == n
    width = plan[0][1] - plan[0][0]
    assert width % TILE_COLS == 0 or len(plan) == 1
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c and b - a == width  # contiguous, ascending, equal widths
    assert all(b > a for a, b in plan)  # no empty split
    assert 8 * m * k * len(plan) <= max(SCRATCH_BYTES, 8 * m * k)


@pytest.mark.parametrize("n", [1, 50, TILE_COLS])
def test_split_plan_keeps_one_split_for_small_n(n):
    assert split_plan(4096, n, 10) == [(0, n)]


def test_split_plan_fills_the_card_at_the_main_path_shapes():
    """A 512-query batch of 64-row strips is 8 strips: the splits make it
    at least one block per SM, where the strips alone would be 8 blocks."""
    for m, n, k in [(512, 60000, 10), (2048, 2048, 16), (10000, 60000, 10)]:
        for per_sm in (1, 2):
            slots = 132 * per_sm
            plan = split_plan(m, n, k, slots)
            strips = -(-m // rows_per_block(k))
            assert strips * len(plan) >= min(slots, strips * MAX_SPLITS) * 0.9


def test_split_plan_caps_the_scratch():
    """More than one split needs an (m, S, k) scratch of at most
    SCRATCH_BYTES; one split writes the output itself."""
    plan = split_plan(10000, 60000, 600, 264)
    assert 1 < len(plan) and 8 * 10000 * 600 * len(plan) <= SCRATCH_BYTES
    assert len(split_plan(10000, 60000, 4000, 264)) == 1


def test_rows_per_block_follows_k():
    assert rows_per_block(10) == 64 and rows_per_block(topk_mod.WIDE_ROWS_K) == 64
    assert rows_per_block(topk_mod.WIDE_ROWS_K + 1) == 32 and rows_per_block(600) == 32
