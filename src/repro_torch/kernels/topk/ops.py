"""Public fused top-k entries: the CUDA kernels for CUDA tensors, the plain
blocked merges for CPU tensors (never a fallback for a CUDA tensor).

``topk`` serves the f32 regimes (matmul and cube families); ``topk_quant``
the int8 corpus-code regime fed by ``core/quant.QuantStore.device_view()``.
Each call reports its work to an open ``dist/roofline`` capture.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import roofline
from repro_torch.kernels.pdist.pdist import CUBE_METRICS, MATMUL_METRICS
from repro_torch.kernels.topk.ref import (
    DEFAULT_BLOCK,
    QUANT_METRICS,
    topk_quant_ref,
    topk_ref,
)
from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda, wide_select

SUPPORTED = MATMUL_METRICS + CUBE_METRICS

__all__ = ["topk", "topk_quant", "SUPPORTED", "MATMUL_METRICS", "CUBE_METRICS",
           "QUANT_METRICS", "wide_select"]


@roofline.reports(lambda a: roofline.topk_work(
    a.X.shape[0], a.Y.shape[0], a.X.shape[1], a.k, cube=a.metric in CUBE_METRICS,
    masked=a.valid is not None))
def topk(
    X: torch.Tensor,
    Y: torch.Tensor,
    *,
    k: int,
    metric: str = "sqeuclidean",
    exclude_self: bool = False,
    valid: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``block`` sizes the plain version's panels; the kernel streams
    tiles of its own."""
    if X.is_cuda:
        return topk_cuda(X, Y, k=k, metric=metric, exclude_self=exclude_self,
                         valid=valid)
    return topk_ref(X, Y, k=k, metric=metric, exclude_self=exclude_self,
                    valid=valid, block=block)


@roofline.reports(lambda a: roofline.topk_int8_work(
    a.Q.shape[0], a.codes.shape[0], a.codes.shape[1], a.k, masked=a.valid is not None))
def topk_quant(
    Q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    *,
    k: int,
    metric: str = "euclidean",
    valid: Optional[torch.Tensor] = None,
    sqnorms: Optional[torch.Tensor] = None,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Int8 fused scan over corpus codes (the first pass of a quantized
    engine).  ``sqnorms`` — per-row squared dequant norms — is recomputed
    when the caller has no ``QuantStore.device_view()`` at hand."""
    if sqnorms is None:
        dec = codes.float() * scales[None, :]
        sqnorms = (dec * dec).sum(1)
    if Q.is_cuda:
        return topk_quant_cuda(Q, codes, scales, sqnorms, k=k, metric=metric,
                               valid=valid)
    return topk_quant_ref(Q, codes, scales, sqnorms, k=k, metric=metric,
                          valid=valid, block=block)
