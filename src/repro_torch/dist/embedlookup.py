"""Embedding lookup (port of ``repro/dist/embedlookup.py``).

A plain gather, as ``jnp.take`` is in JAX outside any kernel.  JAX
constrains the output to the policy's batch sharding (``recsys_policy``
row-shards the table over every mesh axis); every rank of the port's mesh
shares one device, so ``act`` leaves it as it is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.sharding import DistCtx, act


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     dctx: Optional[DistCtx] = None) -> torch.Tensor:
    """table (V, D), ids (...,) int -> (..., D)."""
    out = table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])
    return act(dctx, out, "batch", *([None] * (out.dim() - 1)))
