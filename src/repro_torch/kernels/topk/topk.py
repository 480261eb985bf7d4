"""ctypes bindings of ``csrc/topk.cu`` — fused distance + streaming top-k on
f32 rows (replaces ``repro/kernels/topk/topk.py:_matmul_kernel`` and
``:_cube_kernel``) — and of ``csrc/topk_int8.cu`` — the same over int8
corpus codes (replaces ``:_int8_kernel``)."""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.pdist import METRIC_CODES, regime
from repro_torch.kernels.topk.ref import QUANT_METRICS, quantize_queries

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_INT8_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


#: the f32 scan's geometry (must match ``csrc/topk.cu``): columns per tile,
#: the k above which a strip is 32 rows instead of 64 (up to ``SMEM_MAX_K``)
TILE_COLS = 128
WIDE_ROWS_K = 64
#: the int8 scan's (``csrc/topk_int8.cu``): columns per tile; strips of
#: 128 rows (8 warps of 16), 32 where the lists take the shared memory
INT8_TILE_COLS = 128
#: the largest k whose running lists sit in shared memory
#: (``csrc/common.cuh:SEL_SMEM_MAX_K``); above it the f32 scan writes its
#: distances out and selects from them (``wide_plan``)
SMEM_MAX_K = 512
#: the most column splits (one list head per lane of the merge's warp,
#: ``csrc/common.cuh:MAX_SPLITS``)
MAX_SPLITS = 32
#: the most bytes a scan's scratch may take on the card: the splits' (m, S,
#: k) lists up to ``SMEM_MAX_K``; above it (f32 scan) one row chunk's (rows,
#: n) f32 distances, at least one row
SCRATCH_BYTES = 256 << 20


def rows_per_block(k: int) -> int:
    """Query rows per block of the f32 scan: 64, or 32 where the running
    lists take the shared memory (``WIDE_ROWS_K`` < k <= ``SMEM_MAX_K``)."""
    return 32 if WIDE_ROWS_K < k <= SMEM_MAX_K else 64


def wide_select(k: int) -> bool:
    """Whether the f32 scan writes its distances out and selects the k
    smallest of each row (``csrc/topk.cu``'s select) instead of keeping
    running lists: k > ``SMEM_MAX_K``."""
    return k > SMEM_MAX_K


def int8_rows_per_block(k: int) -> int:
    """Query rows per block of the int8 scan: 128, or 32 where the running
    lists take the shared memory (``WIDE_ROWS_K`` < k <= ``SMEM_MAX_K``)."""
    return 32 if WIDE_ROWS_K < k <= SMEM_MAX_K else 128


def split_plan(m: int, n: int, k: int, slots: int = 2 * 132, *,
               rows: Optional[int] = None,
               tile_cols: int = TILE_COLS) -> list[tuple[int, int]]:
    """The column ranges of a scan's splits: contiguous, ascending, whole
    tiles of ``tile_cols`` except the last, covering [0, n) once.  Each
    (row strip of ``rows`` queries, split) is one block; ``slots`` is how
    many blocks the card holds at once.  The count S minimises the tiles
    the busiest slot scans (waves x tiles per split), the fewest splits
    among equals, with at most ``MAX_SPLITS`` and lists of at most
    ``SCRATCH_BYTES``.  S = 1 for n up to one tile.  The defaults are the
    f32 scan's geometry."""
    strips = -(-max(m, 1) // (rows or rows_per_block(k)))
    most = min(MAX_SPLITS, max(1, SCRATCH_BYTES // (8 * max(m, 1) * k)))
    return _column_ranges(strips, n, slots, tile_cols, most)


def wide_plan(m: int, n: int, slots: int = 2 * 132) -> tuple[int, list[tuple[int, int]]]:
    """The f32 scan's plan where it writes its distances out (k >
    ``SMEM_MAX_K``): rows a chunk, and the column ranges of its splits.
    A chunk's (rows, n) f32 distances fit ``SCRATCH_BYTES`` (a chunk is at
    least one row, and a whole number of strips unless it is the last);
    the chunks cover [0, m) in turn.  The splits keep no lists, so they
    cost no merge: their count only fills the card (``split_plan``'s
    rule, at most one split a slot)."""
    strip = rows_per_block(SMEM_MAX_K + 1)
    chunk = max(1, min(m, SCRATCH_BYTES // (4 * max(n, 1))))
    if strip <= chunk < m:
        chunk -= chunk % strip
    strips = -(-max(chunk, 1) // strip)
    return chunk, _column_ranges(strips, n, slots, TILE_COLS, max(1, slots))


def _column_ranges(strips: int, n: int, slots: int, tile_cols: int,
                   most: int) -> list[tuple[int, int]]:
    """Contiguous, ascending ranges of whole tiles (the last ragged) over
    [0, n), at most ``most``: the count that minimises the tiles the
    busiest slot scans (waves x tiles a split), the fewest among equals."""
    tiles = max(1, -(-n // tile_cols))
    most = min(most, tiles)
    best = (math.inf, 1)
    for splits in range(1, most + 1):
        per = -(-tiles // splits)
        if -(-tiles // per) != splits:  # this count would leave a split empty
            continue
        cost = -(-strips * splits // max(1, slots)) * per
        if cost < best[0]:
            best = (cost, per)
    width = best[1] * tile_cols
    return [(a, min(a + width, n)) for a in range(0, n, width)] or [(0, 0)]


def _slots(metric: str, k: int, device) -> int:
    """Blocks of the f32 scan the card holds at once for this metric and k."""
    return _build.resident_slots("topk_f32_blocks_per_sm", (METRIC_CODES[metric], k), device)


def int8_plan(m: int, n: int, k: int, device) -> list[tuple[int, int]]:
    """The int8 scan's column ranges on this card."""
    rows = int8_rows_per_block(k)
    slots = _build.resident_slots("topk_int8_blocks_per_sm", (k, rows), device)
    return split_plan(m, n, k, slots, rows=rows, tile_cols=INT8_TILE_COLS)


def _copy_width(d: int, *tensors: torch.Tensor) -> int:
    """Bytes per global -> shared copy the int8 scan may use (must match
    ``csrc/topk_int8.cu:Copy``): 16 where every row and base is 16-byte
    aligned, 4 where they are 4-byte aligned, else 1."""
    for width in (16, 4):
        if d % width == 0 and all(t.data_ptr() % width == 0 for t in tensors):
            return width
    return 1


def _check_k(k: int) -> int:
    """Any k >= 1: up to 512 (``csrc/common.cuh:SEL_SMEM_MAX_K``) the
    running lists sit in shared memory; above it the f32 scan writes its
    distances out and selects the k smallest of each row (``wide_plan``),
    and the int8 scan keeps its lists in global memory; slots past the
    valid candidates hold (+inf, -1), k > n included."""
    k = int(k)
    if k < 1:
        raise ValueError(f"topk kernel takes k >= 1, got {k}")
    return k


def _valid_bytes(valid: Optional[torch.Tensor], n: int, device) -> Optional[torch.Tensor]:
    if valid is None:
        return None
    if valid.shape != (n,):
        raise ValueError(f"valid must have shape ({n},), got {tuple(valid.shape)}")
    return valid.to(device=device, dtype=torch.uint8).contiguous()


def topk_cuda(
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    metric: str = "sqeuclidean",
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of Y (n, d) for every row of X (m, d), CUDA f32 ->
    (dists (m, k) f32 ascending, idxs (m, k) int32), by the CUDA kernel:
    the squared norms (matmul family), the scan over ``split_plan``'s
    column ranges and, with more than one, the merge of their lists; above
    ``SMEM_MAX_K``, for each of ``wide_plan``'s row chunks, the scan into
    a distance scratch and the select — on the current stream, one counted
    launch."""
    if metric not in METRIC_CODES:
        raise ValueError(f"topk kernel does not support metric {metric!r}")
    k = _check_k(k)
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError("topk_cuda takes CUDA tensors")
    X = X.float().contiguous()
    Y = Y.float().contiguous()
    m, d = X.shape
    n, d2 = Y.shape
    if d != d2:
        raise ValueError(f"dimension mismatch {tuple(X.shape)} vs {tuple(Y.shape)}")
    vmask = _valid_bytes(valid, n, X.device)
    # the kernel writes every entry: its lists start at (+inf, -1)
    out_d = torch.empty((m, k), dtype=torch.float32, device=X.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=X.device)
    if m == 0:
        return out_d, out_i
    slots = _slots(metric, k, X.device)
    if wide_select(k):
        chunk, plan = wide_plan(m, n, slots)
    else:
        chunk, plan = m, split_plan(m, n, k, slots)
    splits, width = len(plan), max(1, plan[0][1] - plan[0][0])
    norms = (torch.empty(m + n, dtype=torch.float32, device=X.device)
             if regime(metric) == "matmul" else None)
    part_d = part_i = None
    if wide_select(k):
        part_d = torch.empty(max(1, chunk * n), dtype=torch.float32, device=X.device)
    elif splits > 1:
        part_d = torch.empty((m, splits, k), dtype=torch.float32, device=X.device)
        part_i = torch.empty((m, splits, k), dtype=torch.int32, device=X.device)
    aligned = d % 4 == 0 and X.data_ptr() % 16 == 0 and Y.data_ptr() % 16 == 0
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("topk_f32", _ARGTYPES)
    err = fn(X.data_ptr(), Y.data_ptr(), ptr(vmask), out_d.data_ptr(),
             out_i.data_ptr(), ptr(norms), ptr(part_d), ptr(part_i), m, n, d, k,
             METRIC_CODES[metric], int(bool(exclude_self)), splits, width, chunk,
             int(aligned), _build.stream_handle(X.device))
    _build.check(err, "topk_f32")
    _build.note_launch("topk/f32" if regime(metric) == "matmul" else "topk/cube")
    return out_d, out_i


def topk_quant_cuda(
    Q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    sqnorms: torch.Tensor,
    *,
    k: int,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest corpus codes (n, d) int8 for every f32 query row of Q
    (m, d), CUDA -> (dists (m, k) f32 ascending, idxs (m, k) int32), by the
    int8 kernel: the scan over ``int8_plan``'s column ranges and, with more
    than one, the merge of their lists, on the current stream — one counted
    launch.  The query is prepared here (``ref.quantize_queries``), as the
    JAX entry prepares it outside its kernel."""
    if metric not in QUANT_METRICS:
        raise ValueError(f"int8 topk regime does not support metric {metric!r}")
    k = _check_k(k)
    if not all(t.is_cuda for t in (Q, codes, scales, sqnorms)):
        raise ValueError("topk_quant_cuda takes CUDA tensors")
    if codes.dtype != torch.int8:
        raise ValueError(f"codes must be int8, got {codes.dtype}")
    m, d = Q.shape
    n, d2 = codes.shape
    if d != d2 or scales.shape != (d,) or sqnorms.shape != (n,):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, codes "
                         f"{tuple(codes.shape)}, scales {tuple(scales.shape)}, "
                         f"sqnorms {tuple(sqnorms.shape)}")
    xq, alpha, xn = (t.contiguous() for t in quantize_queries(Q, scales.float()))
    codes = codes.contiguous()
    sqnorms = sqnorms.float().contiguous()
    vmask = _valid_bytes(valid, n, Q.device)
    if vmask is not None and vmask.data_ptr() % 4:
        vmask = vmask.clone()  # the kernel copies the mask in 4-byte words
    out_d = torch.empty((m, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=Q.device)
    if m == 0:
        return out_d, out_i
    plan = int8_plan(m, n, k, Q.device)
    splits, width = len(plan), max(1, plan[0][1] - plan[0][0])
    part_d = part_i = bound = None
    if splits > 1:
        part_d = torch.empty((m, splits, k), dtype=torch.float32, device=Q.device)
        part_i = torch.empty((m, splits, k), dtype=torch.int32, device=Q.device)
        # the splits' best k-th distance per row, lowered as they scan
        bound = torch.full((m,), math.inf, dtype=torch.float32, device=Q.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = _build.function("topk_int8", _INT8_ARGTYPES)
    err = fn(xq.data_ptr(), codes.data_ptr(), alpha.data_ptr(), xn.data_ptr(),
             sqnorms.data_ptr(), ptr(vmask), out_d.data_ptr(), out_i.data_ptr(),
             ptr(part_d), ptr(part_i), ptr(bound), m, n, d, k, int(metric == "euclidean"),
             int8_rows_per_block(k), splits, width, _copy_width(d, xq, codes),
             _build.stream_handle(Q.device))
    _build.check(err, "topk_int8")
    _build.note_launch("topk/int8")
    return out_d, out_i
