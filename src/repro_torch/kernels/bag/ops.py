"""Public embedding-bag entry: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors (never a fallback for a CUDA tensor).  Each call
reports its work to an open ``dist/roofline`` capture.

Where autograd records (a table that requires grad, grad mode on), the
bag runs as ``BagFunction``: its forward is the bag, its backward the
bag's backward (``bag_backward`` on the card, ``embedding_bag_backward_ref``
on the CPU), the gradient with respect to the table only.  The backward
takes f32 tables (and f64 in the plain version, for ``gradcheck``); a
half-precision table that requires grad, or weights that require grad,
raise rather than take another path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist import roofline
from repro_torch.kernels.bag.bag import embedding_bag_backward_cuda, embedding_bag_cuda
from repro_torch.kernels.bag.ref import embedding_bag_backward_ref, embedding_bag_ref


def _forward(table, ids, weights, combine):
    if table.is_cuda:
        return embedding_bag_cuda(table, ids, weights, combine=combine)
    return embedding_bag_ref(table, ids, weights, combine=combine)


@roofline.reports(lambda a: roofline.bag_backward_work(
    a.ids, a.grad_out.shape[1], a.num_rows, weighted=a.weights is not None))
def embedding_bag_backward(
    grad_out: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_rows: int,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """grad_out (B, D), ids (B, S), weights (B, S) or None -> the dense
    (num_rows, D) gradient of ``embedding_bag`` with respect to its table."""
    if grad_out.is_cuda:
        return embedding_bag_backward_cuda(grad_out, ids, weights, num_rows,
                                           combine=combine)
    return embedding_bag_backward_ref(grad_out, ids, weights, num_rows, combine=combine)


class BagFunction(torch.autograd.Function):
    """The bag under autograd: d table only (ids and weights get none)."""

    @staticmethod
    def forward(ctx, table, ids, weights, combine):
        ctx.save_for_backward(ids, weights)
        ctx.combine = combine
        ctx.num_rows = table.shape[0]
        return _forward(table, ids, weights, combine)

    @staticmethod
    def backward(ctx, grad_out):
        ids, weights = ctx.saved_tensors
        grad = embedding_bag_backward(grad_out.contiguous(), ids, weights, ctx.num_rows,
                                      combine=ctx.combine)
        return grad, None, None, None


@roofline.reports(lambda a: roofline.bag_work(
    a.ids, a.table.shape[1], weighted=a.weights is not None, elem=a.table.element_size()))
def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """table (V, D) f32, bf16 or f16, ids (B, S) -> (B, D) f32: the weighted
    sum (or mean) of the rows each bag names; ids below 0 are padding
    (weight 0).  Differentiable in ``table`` (f32) through ``BagFunction``."""
    if weights is not None and weights.requires_grad and torch.is_grad_enabled():
        raise ValueError("embedding_bag has no gradient for its weights")
    if table.requires_grad and torch.is_grad_enabled():
        if table.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"embedding_bag's backward takes an f32 table, "
                             f"got {table.dtype}")
        return BagFunction.apply(table, ids, weights, combine)
    return _forward(table, ids, weights, combine)
