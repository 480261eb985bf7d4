"""ctypes binding of ``csrc/pdist.cu`` — the dense distance matrix on the
card (replaces ``repro/kernels/pdist/pdist.py:_matmul_kernel`` and
``:_cube_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MATMUL_METRICS = ("sqeuclidean", "euclidean", "cosine", "dot")
CUBE_METRICS = ("manhattan", "chebyshev")
#: must match ``csrc/common.cuh:rt::Metric``
METRIC_CODES = {"sqeuclidean": 0, "euclidean": 1, "cosine": 2, "dot": 3,
                "manhattan": 4, "chebyshev": 5}

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def regime(metric: str) -> str:
    """The distance family a metric's kernel instance belongs to (the
    suffix of its launch counter)."""
    return "cube" if metric in CUBE_METRICS else "matmul"


def pdist_cuda(X: torch.Tensor, Y: torch.Tensor, *, metric: str) -> torch.Tensor:
    """(m, d) x (n, d) CUDA f32 -> (m, n) distances, by the CUDA kernel."""
    if metric not in METRIC_CODES:
        raise ValueError(f"pdist kernel does not support metric {metric!r}")
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError("pdist_cuda takes CUDA tensors")
    X = X.float().contiguous()
    Y = Y.float().contiguous()
    m, d = X.shape
    n, d2 = Y.shape
    if d != d2:
        raise ValueError(f"dimension mismatch {tuple(X.shape)} vs {tuple(Y.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=X.device)
    if m == 0 or n == 0:
        return out
    # the matmul family's squared norms, from the kernel's pre-pass
    norms = (torch.empty(m + n, dtype=torch.float32, device=X.device)
             if regime(metric) == "matmul" else None)
    aligned = d % 4 == 0 and X.data_ptr() % 16 == 0 and Y.data_ptr() % 16 == 0
    fn = _build.function("pdist_f32", _ARGTYPES)
    err = fn(X.data_ptr(), Y.data_ptr(), out.data_ptr(),
             None if norms is None else norms.data_ptr(), m, n, d,
             METRIC_CODES[metric], int(aligned), _build.stream_handle(X.device))
    _build.check(err, "pdist_f32")
    _build.note_launch(f"pdist/{regime(metric)}")
    return out
