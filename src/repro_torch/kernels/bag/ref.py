"""Plain PyTorch version of the embedding-bag kernel (``csrc/bag.cu``).

table (V, D) f32, bf16 or f16, ids (B, S) int, optional weights (B, S) ->
(B, D) f32; each gathered slice of a bf16 or f16 table is cast to f32
before its product, as JAX's kernel casts each row
(``repro/kernels/bag/bag.py:38``).
Ids below 0 are padding: they read row 0 with weight 0 (the product is
still formed, as in ``repro/kernels/bag``).  ``combine="mean"`` divides by
``max(sum_s w, 1e-9)``, so an all-padding row gives 0.  The sum runs in
ascending s, one gathered (B, D) slice at a time, each product and sum
rounded on its own — the kernel's arithmetic, so the two agree bit for bit
— and the (B, S, D) gather never exists.  An f64 table (the plain version
only: the kernel takes none) is summed in f64, for ``gradcheck``.

``embedding_bag_backward_ref`` is the plain version of the backward
kernel (``csrc/bag.cu:bag_backward``), the gradient with respect to the
table: ``grad[ids[b, s]] += w[b, s] * g[b]`` by ``index_add_``, where
``g[b]`` is divided by ``max(sum_s w[b, s], 1e-9)`` under
``combine="mean"`` (the forward's denominator: the count of valid ids
without weights) and padding ids add nothing.  The same products as the
kernel, summed in another order (the kernel's f32 atomics land in any
order), so the two agree to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

COMBINES = ("sum", "mean")
#: the table dtypes both versions take, in the order of the kernel's codes
#: (``csrc/bag.cu:TableDtype``)
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: what the plain versions take besides: an f64 table, summed in f64
PLAIN_DTYPES = TABLE_DTYPES + (torch.float64,)


def check_args(table: torch.Tensor, ids: torch.Tensor,
               weights: Optional[torch.Tensor], combine: str) -> None:
    """What both versions take: an f32, bf16 or f16 (V, D) table, (B, S)
    ids, weights of the ids' shape, ``sum`` or ``mean``."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if table.dtype not in PLAIN_DTYPES:
        raise ValueError(f"embedding_bag takes an f32, bf16 or f16 table (f64 in the "
                         f"plain version), got {table.dtype}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table (V, D) and ids (B, S) expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must match ids "
                         f"{tuple(ids.shape)}")


def effective_weights(ids: torch.Tensor, weights: Optional[torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) f32 (or ``dtype``): the caller's weights (or 1) times 0 at
    padding ids."""
    valid = (ids >= 0).to(dtype)
    return valid if weights is None else weights.to(dtype) * valid


def _acc_dtype(table: torch.Tensor) -> torch.dtype:
    return torch.float64 if table.dtype == torch.float64 else torch.float32


def embedding_bag_ref(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    check_args(table, ids, weights, combine)
    B, S = ids.shape
    acc = _acc_dtype(table)
    w = effective_weights(ids, weights, acc)
    safe = ids.clamp_min(0).long()
    out = torch.zeros((B, table.shape[1]), dtype=acc, device=table.device)
    wsum = torch.zeros((B, 1), dtype=acc, device=table.device)
    for s in range(S):
        ws = w[:, s:s + 1]
        out = out + ws * table.index_select(0, safe[:, s]).to(acc)
        wsum = wsum + ws
    if combine == "mean":
        out = out / wsum.clamp_min(1e-9)
    return out


def check_backward_args(grad_out: torch.Tensor, ids: torch.Tensor,
                        weights: Optional[torch.Tensor], combine: str) -> None:
    """What both backward versions take: a (B, D) f32 (f64 in the plain
    version) output gradient for (B, S) ids."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if grad_out.dim() != 2 or ids.dim() != 2 or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"grad_out (B, D) and ids (B, S) expected, got "
                         f"{tuple(grad_out.shape)} and {tuple(ids.shape)}")
    if grad_out.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the bag's backward takes an f32 output gradient, "
                         f"got {grad_out.dtype}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must match ids "
                         f"{tuple(ids.shape)}")


def bag_scale(ids: torch.Tensor, weights: Optional[torch.Tensor], combine: str,
              dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """((B, S) effective weights, (B, 1) divisor of each bag's output
    gradient): 1, or ``max(sum_s w, 1e-9)`` under ``mean`` (summed in
    ascending s, as the forward sums it)."""
    w = effective_weights(ids, weights, dtype)
    div = torch.ones((ids.shape[0], 1), dtype=dtype, device=ids.device)
    if combine == "mean":
        wsum = torch.zeros_like(div)
        for s in range(ids.shape[1]):
            wsum = wsum + w[:, s:s + 1]
        div = wsum.clamp_min(1e-9)
    return w, div


def embedding_bag_backward_ref(
    grad_out: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor],
    num_rows: int,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    """grad_out (B, D), ids (B, S), weights (B, S) or None -> the (num_rows,
    D) gradient of ``embedding_bag`` with respect to its table (dense, in
    grad_out's dtype): one ``index_add_`` of ``w[b, s] * (g[b] / div[b])``
    into row ``ids[b, s]`` for every valid id.  A padding id adds +0.0 to
    row 0, which changes no value (and keeps every shape independent of
    the ids, so the function runs on meta tensors)."""
    check_backward_args(grad_out, ids, weights, combine)
    B, S = ids.shape
    D = grad_out.shape[1]
    w, div = bag_scale(ids, weights, combine, grad_out.dtype)
    valid = (ids >= 0).reshape(-1, 1)
    contrib = (w[:, :, None] * (grad_out / div)[:, None, :]).reshape(B * S, D)
    contrib = torch.where(valid, contrib, 0.0)
    grad = torch.zeros((num_rows, D), dtype=grad_out.dtype, device=grad_out.device)
    return grad.index_add_(0, ids.reshape(-1).clamp_min(0).long(), contrib)

