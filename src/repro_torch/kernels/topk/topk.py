"""ctypes bindings of ``csrc/topk.cu`` — fused distance + streaming top-k on
f32 rows (replaces ``repro/kernels/topk/topk.py:_matmul_kernel`` and
``:_cube_kernel``) — and of ``csrc/topk_int8.cu`` — the same over int8
corpus codes (replaces ``:_int8_kernel``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pdist.pdist import METRIC_CODES, regime
from repro_torch.kernels.topk.ref import QUANT_METRICS, quantize_queries

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INT8_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _check_k(k: int) -> int:
    """Any k >= 1: up to 512 the running lists sit in shared memory, above
    it in the output buffers (``csrc/common.cuh:SEL_SMEM_MAX_K``); slots past
    the valid candidates hold (+inf, -1), k > n included."""
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
    (dists (m, k) f32 ascending, idxs (m, k) int32), by the CUDA kernel."""
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
    fn = _build.function("topk_f32", _ARGTYPES)
    err = fn(X.data_ptr(), Y.data_ptr(),
             None if vmask is None else vmask.data_ptr(),
             out_d.data_ptr(), out_i.data_ptr(), m, n, d, k, METRIC_CODES[metric],
             int(bool(exclude_self)), _build.stream_handle(X.device))
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
    int8 kernel.  The query is prepared here (``ref.quantize_queries``), as
    the JAX entry prepares it outside its kernel."""
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
    out_d = torch.empty((m, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=Q.device)
    if m == 0:
        return out_d, out_i
    aligned = d % 4 == 0 and xq.data_ptr() % 4 == 0 and codes.data_ptr() % 4 == 0
    fn = _build.function("topk_int8", _INT8_ARGTYPES)
    err = fn(xq.data_ptr(), codes.data_ptr(), alpha.data_ptr(), xn.data_ptr(),
             sqnorms.data_ptr(),
             None if vmask is None else vmask.data_ptr(),
             out_d.data_ptr(), out_i.data_ptr(), m, n, d, k,
             int(metric == "euclidean"), int(aligned),
             _build.stream_handle(Q.device))
    _build.check(err, "topk_int8")
    _build.note_launch("topk/int8")
    return out_d, out_i
