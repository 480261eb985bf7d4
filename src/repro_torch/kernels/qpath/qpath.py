"""ctypes binding of ``csrc/qpath.cu`` — the (min, combine) semiring
product on the card (replaces ``repro/kernels/qpath/qpath.py:_qpath_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: must match ``csrc/qpath.cu:Mode``
MODE_CODES = {"minplus": 0, "minmax": 1, "logminplus": 2}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    out = torch.full((m, n), float("inf"), dtype=torch.float32, device=A.device)
    if m == 0 or n == 0 or kd == 0:
        return out
    fn = _build.function("qpath_f32", _ARGTYPES)
    err = fn(A.data_ptr(), B.data_ptr(), out.data_ptr(), m, kd, n,
             MODE_CODES[mode], _build.stream_handle(A.device))
    _build.check(err, "qpath_f32")
    _build.note_launch(f"qpath/{mode}")
    return out
