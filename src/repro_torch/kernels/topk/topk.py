"""ctypes binding of ``csrc/topk.cu`` — fused distance + streaming top-k on
the card (replaces ``repro/kernels/topk/topk.py:_matmul_kernel``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.pdist import CUBE_METRICS, METRIC_CODES

#: largest k the kernel's shared-memory running top-k holds
MAX_K = 128

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])


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
    (dists (m, k) f32 ascending, idxs (m, k) int32), by the CUDA kernel."""
    if metric in CUBE_METRICS:
        raise NotImplementedError(
            f"topk metric {metric!r}: the manhattan/chebyshev kernel "
            "(repro/kernels/topk/topk.py:_cube_kernel) is not ported yet"
        )
    if metric not in METRIC_CODES:
        raise ValueError(f"topk kernel does not support metric {metric!r}")
    k = int(k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk kernel supports 1 <= k <= {MAX_K}, got {k}")
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError("topk_cuda takes CUDA tensors")
    X = X.float().contiguous()
    Y = Y.float().contiguous()
    m, d = X.shape
    n, d2 = Y.shape
    if d != d2:
        raise ValueError(f"dimension mismatch {tuple(X.shape)} vs {tuple(Y.shape)}")
    vmask = None
    if valid is not None:
        if valid.shape != (n,):
            raise ValueError(f"valid must have shape ({n},), got {tuple(valid.shape)}")
        vmask = valid.to(device=X.device, dtype=torch.uint8).contiguous()
    out_d = torch.full((m, k), float("inf"), dtype=torch.float32, device=X.device)
    out_i = torch.full((m, k), -1, dtype=torch.int32, device=X.device)
    if m == 0:
        return out_d, out_i
    fn = _build.function("topk_f32", _ARGTYPES)
    err = fn(X.data_ptr(), Y.data_ptr(),
             None if vmask is None else vmask.data_ptr(),
             out_d.data_ptr(), out_i.data_ptr(), m, n, d, k, METRIC_CODES[metric],
             int(bool(exclude_self)), _build.stream_handle(X.device))
    _build.check(err, "topk_f32")
    _build.note_launch("topk")
    return out_d, out_i
