"""ctypes binding of ``csrc/qpath.cu`` — the (min, combine) semiring
product on the card (replaces ``repro/kernels/qpath/qpath.py:_qpath_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: must match ``csrc/qpath.cu:Mode``
MODE_CODES = {"minplus": 0, "minmax": 1, "logminplus": 2}
#: the kernel's geometry (must match ``csrc/qpath.cu:tile`` and ``BK``):
#: output rows and columns per block in each mode, k per pipeline stage
TILE = {"minplus": 128, "minmax": 128, "logminplus": 64}
STAGE_K = 32
#: the fewest k a split takes (two stages): shorter ranges spend their time
#: filling the pipeline
MIN_SPLIT_K = 2 * STAGE_K
#: blocks a plan may give each slot of the card: logminplus's work per block
#: follows its data (the skip; clustered or banded graphs put most of it in
#: a few tiles), so it cuts k finer to spread that work over the SMs.  8
#: read best or within 1 % of best among 1, 4, 8 and 16 on the builds'
#: 512^3 and 1000^3 sweeps and the 2048^3 operands (tools/profile_qpath.py,
#: NVIDIA H100 80GB HBM3, 700 W; PERF.md)
WAVES = {"minplus": 1, "minmax": 1, "logminplus": 8}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def split_plan(m: int, kd: int, n: int, slots: int, tile: int = 128,
               waves: int = 1) -> tuple[int, int]:
    """(splits, k per split) of an (m, kd) x (kd, n) product in output
    tiles of ``tile`` x ``tile``: k is cut into ranges of whole stages, one
    block per (output tile, range), so that the tiles times the splits make
    at most ``waves`` x ``slots`` blocks (``slots``: the blocks the card
    holds at once), with at least ``MIN_SPLIT_K`` k a range.  One split
    where the tiles alone fill that."""
    tiles = _cdiv(m, tile) * _cdiv(n, tile)
    most = max(1, min(waves * slots // tiles, kd // MIN_SPLIT_K))
    per = _cdiv(_cdiv(kd, most), STAGE_K) * STAGE_K
    return _cdiv(kd, per), per


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def qpath_matmul_cuda(A: torch.Tensor, B: torch.Tensor, *, mode: str) -> torch.Tensor:
    """(m, k) x (k, n) CUDA f32 -> (m, n), by the CUDA kernel."""
    if mode not in MODE_CODES:
        raise ValueError(f"unknown semiring mode {mode!r}")
    if not (A.is_cuda and B.is_cuda):
        raise ValueError("qpath_matmul_cuda takes CUDA tensors")
    A = A.float().contiguous()
    B = B.float().contiguous()
    m, kd = A.shape
    k2, n = B.shape
    if kd != k2:
        raise ValueError(f"inner dimensions differ: {tuple(A.shape)} x {tuple(B.shape)}")
    if kd == 0:
        return torch.full((m, n), float("inf"), dtype=torch.float32, device=A.device)
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    if m == 0 or n == 0:
        return out
    code = MODE_CODES[mode]
    splits, per = split_plan(
        m, kd, n, _build.resident_slots("qpath_blocks_per_sm", (code,), A.device),
        TILE[mode], WAVES[mode])
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=A.device)
            if splits > 1 else None)
    aligned = (kd % 4 == 0 and n % 4 == 0
               and A.data_ptr() % 16 == 0 and B.data_ptr() % 16 == 0)
    fn = _build.function("qpath_f32", _ARGTYPES)
    err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), m, kd, n, code, splits, per,
             int(aligned), _build.stream_handle(A.device))
    _build.check(err, "qpath_f32")
    _build.note_launch(f"qpath/{mode}")
    return out
