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
— and the (B, S, D) gather never exists.
"""
from __future__ import annotations

from typing import Optional

import torch

COMBINES = ("sum", "mean")
#: the table dtypes both versions take, in the order of the kernel's codes
#: (``csrc/bag.cu:TableDtype``)
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check_args(table: torch.Tensor, ids: torch.Tensor,
               weights: Optional[torch.Tensor], combine: str) -> None:
    """What both versions take: an f32, bf16 or f16 (V, D) table, (B, S)
    ids, weights of the ids' shape, ``sum`` or ``mean``."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    if table.dtype not in TABLE_DTYPES:
        raise ValueError(f"embedding_bag takes an f32, bf16 or f16 table, "
                         f"got {table.dtype}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table (V, D) and ids (B, S) expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"weights {tuple(weights.shape)} must match ids "
                         f"{tuple(ids.shape)}")


def effective_weights(ids: torch.Tensor,
                      weights: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, S) f32: the caller's weights (or 1) times 0 at padding ids."""
    valid = (ids >= 0).to(torch.float32)
    return valid if weights is None else weights.float() * valid


def embedding_bag_ref(
    table: torch.Tensor,
    ids: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    combine: str = "sum",
) -> torch.Tensor:
    check_args(table, ids, weights, combine)
    B, S = ids.shape
    w = effective_weights(ids, weights)
    safe = ids.clamp_min(0).long()
    out = torch.zeros((B, table.shape[1]), dtype=torch.float32, device=table.device)
    wsum = torch.zeros((B, 1), dtype=torch.float32, device=table.device)
    for s in range(S):
        ws = w[:, s:s + 1]
        out = out + ws * table.index_select(0, safe[:, s]).float()
        wsum = wsum + ws
    if combine == "mean":
        out = out / wsum.clamp_min(1e-9)
    return out
