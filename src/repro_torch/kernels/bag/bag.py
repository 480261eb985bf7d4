"""ctypes binding of ``csrc/bag.cu`` — the embedding bag on the card
(replaces ``repro/kernels/bag/bag.py:_bag_kernel``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bag.ref import TABLE_DTYPES, check_args

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def embedding_bag_cuda(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """table (V, D) f32, bf16 or f16, ids (B, S), weights (B, S) or None,
    all CUDA -> (B, D) f32, by the CUDA kernel.  The table is read in its
    own dtype (no f32 copy); ids are taken as int32 (a copy when they are
    not)."""
    check_args(table, ids, weights, combine)
    if not (table.is_cuda and ids.is_cuda and (weights is None or weights.is_cuda)):
        raise ValueError("embedding_bag_cuda takes CUDA tensors")
    table = table.contiguous()
    ids = ids.to(torch.int32).contiguous()
    if weights is not None:
        weights = weights.float().contiguous()
    B, S = ids.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0 or D == 0:
        return out
    fn = _build.function("bag_f32", _ARGTYPES)
    # the kernel's dtype code is the position in TABLE_DTYPES (bag.cu:TableDtype)
    err = fn(table.data_ptr(), TABLE_DTYPES.index(table.dtype), ids.data_ptr(),
             None if weights is None else weights.data_ptr(), out.data_ptr(),
             B, S, D, int(combine == "mean"), _build.stream_handle(table.device))
    _build.check(err, "bag_f32")
    _build.note_launch("bag")
    return out
