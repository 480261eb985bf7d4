"""The topk kernels' column splits (``kernels/topk/topk.py:split_plan``),
on the CPU, in the f32 scan's geometry and in the int8 scan's (strips of
``int8_rows_per_block(k)`` rows, tiles of ``INT8_TILE_COLS`` columns), and
the f32 scan's row chunks and splits above ``SMEM_MAX_K``, where it writes
its distances out and selects from them (``wide_plan``): the plans are pure
arithmetic, so their contracts are checked here, with the merge's plain
version over split lists and the wide path's counter; the scans, the merge
and the select kernels are held to their plain versions on the card
(``test_torch_cuda.py::test_topk_kernel_splits``,
``::test_topk_int8_kernel_splits``, ``::test_topk_kernel_wide_select``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quant as quant_lib  # noqa: E402
from repro_torch.core import scan as scan_lib  # noqa: E402
from repro_torch.core import telemetry as telem  # noqa: E402
from repro_torch.kernels.topk import ops as topk_ops  # noqa: E402
from repro_torch.kernels.topk import topk as topk_mod  # noqa: E402
from repro_torch.kernels.topk.ref import merge_splits_ref, topk_quant_ref  # noqa: E402
from repro_torch.kernels.topk.topk import (  # noqa: E402
    INT8_TILE_COLS, MAX_SPLITS, SCRATCH_BYTES, SMEM_MAX_K, TILE_COLS, int8_rows_per_block,
    rows_per_block, split_plan, wide_plan, wide_select,
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
# the int8 scan's: the quantized brute batch and whole query set (K = 64)
# at one and two resident blocks per SM, 32-row strips (64 < k <= 512),
# global lists (k = 600, 2500), ragged strips and tiny shapes
INT8_SHAPES = [
    (512, 60000, 64, 132), (512, 60000, 64, 264), (10000, 60000, 64, 132),
    (512, 60000, 600, 132), (40, 4096, 200, 264), (200, 5000, 10, 132),
    (37, 8000, 2500, 132), (9, 1000, 1500, 132), (1, 1, 1, 132), (6, 10, 25, 132),
]
GEOMETRIES = {"f32": dict(rows=None, tile_cols=TILE_COLS),
              "int8": dict(rows=int8_rows_per_block, tile_cols=INT8_TILE_COLS)}
PLANS = ([pytest.param(*s, "f32", id="-".join(map(str, s))) for s in SHAPES]
         + [pytest.param(*s, "int8", id="int8-" + "-".join(map(str, s)))
            for s in INT8_SHAPES])


def _plan(m, n, k, slots, geometry):
    g = GEOMETRIES[geometry]
    rows = g["rows"] and g["rows"](k)
    return split_plan(m, n, k, slots, rows=rows, tile_cols=g["tile_cols"])


@pytest.mark.parametrize("m,n,k,slots,geometry", PLANS)
def test_split_plan_covers_the_columns_once_in_order(m, n, k, slots, geometry):
    plan = _plan(m, n, k, slots, geometry)
    assert 1 <= len(plan) <= MAX_SPLITS
    assert plan[0][0] == 0 and plan[-1][1] == n
    width = plan[0][1] - plan[0][0]
    assert width % GEOMETRIES[geometry]["tile_cols"] == 0 or len(plan) == 1
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


@pytest.mark.parametrize("m,n,k", [(512, 60000, 64), (10000, 60000, 64)])
@pytest.mark.parametrize("per_sm", [1, 2])
def test_int8_split_plan_fills_the_card_at_the_main_path_shapes(m, n, k, per_sm):
    """A 512-query batch of 128-row strips is 4 strips: the splits make it
    about one block per SM, where the strips alone were 4 blocks (16 in
    the first int8 design's 32-row strips)."""
    slots = 132 * per_sm
    plan = _plan(m, n, k, slots, "int8")
    strips = -(-m // int8_rows_per_block(k))
    assert strips * len(plan) >= min(slots, strips * MAX_SPLITS) * 0.9


def test_int8_split_plan_caps_the_scratch():
    """The int8 scan's (m, S, k) lists obey the same cap; past it, one
    split writes the output itself."""
    plan = _plan(10000, 60000, 600, 132, "int8")
    assert 1 < len(plan) and 8 * 10000 * 600 * len(plan) <= SCRATCH_BYTES
    assert len(_plan(10000, 60000, 4000, 132, "int8")) == 1


def test_int8_rows_per_block_follows_k():
    assert int8_rows_per_block(64) == 128 and int8_rows_per_block(65) == 32
    assert int8_rows_per_block(topk_mod.SMEM_MAX_K) == 32
    assert int8_rows_per_block(topk_mod.SMEM_MAX_K + 1) == 128


def test_split_plan_caps_the_scratch():
    """More than one split needs an (m, S, k) scratch of at most
    SCRATCH_BYTES; one split writes the output itself."""
    plan = split_plan(10000, 60000, 600, 264)
    assert 1 < len(plan) and 8 * 10000 * 600 * len(plan) <= SCRATCH_BYTES
    assert len(split_plan(10000, 60000, 4000, 264)) == 1


def test_rows_per_block_follows_k():
    """64-row strips up to ``WIDE_ROWS_K``, 32 where the lists take the
    shared memory, 64 again above ``SMEM_MAX_K``, where the scan keeps no
    lists and writes its distances out."""
    assert rows_per_block(10) == 64 and rows_per_block(topk_mod.WIDE_ROWS_K) == 64
    assert rows_per_block(topk_mod.WIDE_ROWS_K + 1) == 32
    assert rows_per_block(SMEM_MAX_K) == 32 and rows_per_block(SMEM_MAX_K + 1) == 64
    assert rows_per_block(600) == 64 and rows_per_block(4096) == 64


def test_wide_select_follows_k():
    assert not wide_select(10) and not wide_select(SMEM_MAX_K)
    assert wide_select(SMEM_MAX_K + 1) and wide_select(4096)


# (m, n, slots): the live cell's frozen oversample and a live shard's, the
# ground truth at k > 512 (several chunks), the NSW graph's square shape,
# ragged and tiny shapes, n = 0, and an n whose one row passes the cap
WIDE_SHAPES = [
    (512, 60000, 264), (512, 60000, 132), (512, 30000, 264), (10000, 60000, 264),
    (60000, 60000, 264), (9, 1000, 264), (40, 3000, 132), (33, 257, 264), (1, 1, 264),
    (130, 129, 264), (7, 0, 264), (3, 80_000_000, 264),
]


@pytest.mark.parametrize("m,n,slots", WIDE_SHAPES,
                         ids=["-".join(map(str, s)) for s in WIDE_SHAPES])
def test_wide_plan_covers_rows_and_columns_once_in_order(m, n, slots):
    """The chunks cover [0, m) in turn, each a whole number of 64-row
    strips but the last; the splits cover [0, n) as ``split_plan``'s do,
    without its cap on their count (no lists to merge), one at most a
    slot."""
    chunk, plan = wide_plan(m, n, slots)
    strip = rows_per_block(SMEM_MAX_K + 1)
    assert 1 <= chunk <= m
    starts = list(range(0, m, chunk))
    ends = [min(m, a + chunk) for a in starts]
    assert ends[-1] == m and all(b == c for b, c in zip(ends, starts[1:]))
    assert chunk == m or chunk % strip == 0 or chunk < strip
    assert plan[0][0] == 0 and plan[-1][1] == n
    assert 1 <= len(plan) <= max(1, min(slots, -(-n // TILE_COLS)))
    width = plan[0][1] - plan[0][0]
    assert width % TILE_COLS == 0 or len(plan) == 1
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert b == c and b - a == width  # contiguous, ascending, equal widths
    assert all(b > a for a, b in plan) or n == 0


@pytest.mark.parametrize("m,n,slots", WIDE_SHAPES,
                         ids=["-".join(map(str, s)) for s in WIDE_SHAPES])
def test_wide_plan_scratch_fits_the_cap(m, n, slots):
    """A chunk's (rows, n) f32 distances never pass ``SCRATCH_BYTES``,
    except a single row that alone passes it (n > 64 M)."""
    chunk, _ = wide_plan(m, n, slots)
    assert 4 * chunk * n <= max(SCRATCH_BYTES, 4 * n)
    if 4 * n > SCRATCH_BYTES:
        assert chunk == 1


def test_wide_plan_is_one_chunk_at_the_live_shape():
    """The live cell's frozen oversample (512 x 60 000 at k' = 4 096) is one
    chunk of 123 MB, and its 8 strips of 64 rows fill the card's slots at
    one and two blocks an SM, where the lists' plan ran 16 splits of 3 840
    columns for 16 32-row strips; the ground truth's 10 000 rows take
    chunks of 1 088."""
    for slots in (132, 264):
        chunk, plan = wide_plan(512, 60000, slots)
        assert chunk == 512 and 4 * 512 * 60000 <= SCRATCH_BYTES
        strips = 512 // rows_per_block(4096)
        assert strips * len(plan) >= 0.9 * slots
        assert -(-strips * len(plan) // slots) == 1  # one wave
    assert wide_plan(10000, 60000)[0] == 1088


@pytest.mark.parametrize("metric,k,family", [
    ("euclidean", 4096, "matmul"), ("sqeuclidean", 513, "matmul"),
    ("manhattan", 600, "cube"), ("chebyshev", 600, "cube"), ("euclidean", 512, None),
    ("euclidean", 10, None), ("manhattan", 16, None),
])
def test_wide_select_counter_counts_kernel_calls_past_512(monkeypatch, metric, k, family):
    """``core/scan.topk_scan`` counts ``topk_wide_select_total{family}`` once
    for each call that reaches the f32 kernel at k > 512, and never at k <=
    512 or on the CPU (the kernel's entry is stubbed: no card here)."""
    class CudaRows:
        is_cuda = True

    calls = []
    monkeypatch.setattr(topk_ops, "topk", lambda *a, **kw: calls.append(kw["k"]))
    was = telem.enabled()
    telem.enable()
    telem.reset()
    try:
        scan_lib.topk_scan(CudaRows(), CudaRows(), k=k, metric=metric)
        scan_lib.topk_scan(CudaRows(), CudaRows(), k=k, metric=metric)
        wide = {f: telem.counter_total("topk_wide_select_total", family=f)
                for f in ("matmul", "cube")}
        X = torch.zeros((3, 4))
        scan_lib.topk_scan(X, X, k=k, metric=metric)  # the CPU: no kernel
        assert telem.counter_total("topk_wide_select_total") == sum(wide.values())
    finally:
        telem.reset()
        telem.enable(was)
    assert calls == [k, k, k]
    assert wide == {f: 2.0 if f == family else 0.0 for f in ("matmul", "cube")}


@pytest.mark.parametrize("k", [10, 64, 700])
def test_merge_of_split_lists_is_the_whole_top_k(k):
    """``ref.merge_splits_ref`` (the function of the kernels' merge, which
    ``chip_smoke.py`` holds ``topk_merge`` to) over the int8 plain
    version's top k of each split's columns equals the plain top k over
    all columns, bit for bit: duplicate rows tie across splits and k may
    exceed a split (k = 700) or leave (+inf, -1) slots."""
    rng = np.random.default_rng(k)
    X = torch.as_tensor(rng.normal(size=(1500, 24)).astype(np.float32))
    X = torch.cat([X, X])  # row j and j + 1500 lie in different splits
    Q = torch.as_tensor(rng.normal(size=(9, 24)).astype(np.float32))
    codes, scales, sqn = quant_lib.QuantStore.build(X, device="cpu").device_view()
    plan = split_plan(9, 3000, k, 132, rows=int8_rows_per_block(k),
                      tile_cols=INT8_TILE_COLS)
    assert len(plan) > 1
    parts = [topk_quant_ref(Q, codes[a:b], scales, sqn[a:b], k=k) for a, b in plan]
    part_d = torch.stack([d for d, _ in parts], 1)
    part_i = torch.stack([torch.where(i >= 0, i + a, i)
                          for (_, i), (a, _) in zip(parts, plan)], 1)
    md, mi = merge_splits_ref(part_d, part_i, k)
    rd, ri = topk_quant_ref(Q, codes, scales, sqn, k=k)
    assert torch.equal(md, rd) and torch.equal(mi, ri)
