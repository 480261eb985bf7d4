"""Serve-step factories (port of ``repro/train/train_step.py``).

``make_serve_step(cfg, "recsys")`` scores a batch of ids (the
``serve_p99`` / ``serve_bulk`` shapes); ``make_retrieval_step(cfg, k=)``
embeds the query ids and returns the top-k candidates (the
``retrieval_cand`` shape).  Each returned step takes ``(params, batch)``,
with ``params`` a ``models.recsys.RecsysModel`` or the same tree as a
dict, and runs under ``torch.inference_mode``.  The train step (the bag's
backward, the optimizer, gradient compression), the GNN serve step and the
LM decode and prefill steps wait for their slices.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.recsys import recsys_forward, retrieval_score, user_embedding


def make_serve_step(cfg, family: str) -> Callable:
    """Forward-only scoring step: ``serve(params, {"ids": (B, F)})`` ->
    click probabilities (B,)."""
    if family != "recsys":
        raise KeyError(f"no serve step for family {family!r} in the port yet")

    def serve(params, batch):
        with torch.inference_mode():
            return torch.sigmoid(recsys_forward(params, batch["ids"], cfg))

    return serve


def make_retrieval_step(cfg, *, k: int = 100) -> Callable:
    """recsys retrieval_cand: ``retrieve(params, {"ids": (B, F),
    "candidates": (N, D)})`` -> (scores (B, k), ids (B, k))."""

    def retrieve(params, batch):
        with torch.inference_mode():
            u = user_embedding(params, batch["ids"], cfg)
            return retrieval_score(u, batch["candidates"], k=k)

    return retrieve
