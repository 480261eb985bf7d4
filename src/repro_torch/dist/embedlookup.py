"""Embedding lookup (port of ``repro/dist/embedlookup.py``), single device.

A plain gather, as ``jnp.take`` is in JAX outside any kernel.  The sharded
form (a row-sharded table over a mesh) waits for the port's ``dist/``.
"""
from __future__ import annotations

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D), ids (...,) int -> (..., D)."""
    flat = table.index_select(0, ids.reshape(-1))
    return flat.reshape(*ids.shape, table.shape[1])
