"""Train and serve step factories (port of ``repro/train/train_step.py``).

``make_train_step(cfg, family, opt)`` (``lm``, ``recsys`` or ``gnn``)
returns ``train_step(params, opt_state, batch) -> (params, opt_state,
metrics)``: the loss and its gradient over every leaf of the parameter
tree (``torch.autograd.grad``), optional microbatch accumulation and int8
gradient compression, then ``opt.update``.  ``make_serve_step(cfg,
"recsys")`` scores a batch of ids (the ``serve_p99`` / ``serve_bulk``
shapes; the xDeepFM CIN in chunks of ``models.recsys.CIN_CHUNK`` rows);
``make_serve_step(cfg, "gnn")`` gives the GCN's logits over a graph;
``make_retrieval_step(cfg, k=)`` embeds the query ids and returns the
top-k candidates (``retrieval_cand``); ``make_prefill_step`` /
``make_decode_step`` serve the LMs (prefill, then greedy decode through
the cache; ``mla_absorb`` picks MLA's absorbed decode).  Serve steps take
``(params, ...)``, with ``params`` a model (``RecsysModel``, ``GCNModel``,
``LMModel``) or the same tree as a dict, and run under
``torch.inference_mode``.  Every factory takes JAX's ``dctx`` (a
``dist/sharding.DistCtx``, after ``family`` / ``opt``) and hands it to the
model: an LM's MoE layers then run expert-parallel over the mesh's ranks.
The port's ``shard_map`` has no gradient yet, so an LM train step under a
mesh whose batch takes the expert-parallel path raises.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.dist import compression as comp_lib
from repro_torch.models.gnn import gcn_forward, gcn_loss
from repro_torch.models.recsys import (
    recsys_forward, recsys_loss, retrieval_score, user_embedding,
)
from repro_torch.models.transformer import greedy, lm_decode_step, lm_loss, lm_prefill
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import tree as tree_lib

Tree = Any


def _loss_fn_for(family: str):
    if family == "lm":
        return lm_loss
    if family == "recsys":
        return recsys_loss
    if family == "gnn":
        return gcn_loss
    raise KeyError(family)


def value_and_grad(loss_fn: Callable, params: Tree, batch: dict, cfg, dctx=None) -> tuple:
    """(grads as ``params``' tree, metrics detached) of ``loss_fn(params,
    batch, cfg, dctx) -> (loss, metrics)``.  The leaves are detached views that
    require grad (no copy); parameters made under ``inference_mode`` cannot
    be saved for backward and are refused."""
    flat, spec = tree_lib.flatten(params)
    if any(p.is_inference() for p in flat):
        raise ValueError("training parameters were made under torch.inference_mode; "
                         "make them outside it")
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_lib.unflatten(spec, live), batch, cfg, dctx)
        grads = torch.autograd.grad(loss, live)
    return (tree_lib.unflatten(spec, list(grads)),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(
    cfg,
    family: str,
    opt: opt_lib.Optimizer,
    dctx=None,
    *,
    microbatches: int = 1,
    grad_compression: Optional[str] = None,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``.  With ``microbatches`` > 1 the leading batch dimension is
    split, the gradients are accumulated in the parameter dtype and divided
    by ``microbatches``, and the metrics are the last microbatch's, as in
    JAX.  ``grad_compression="int8"`` sends the gradients through
    ``fake_int8_roundtrip`` before the update."""
    loss_fn = _loss_fn_for(family)
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def compute_grads(params, batch):
        if microbatches <= 1:
            return value_and_grad(loss_fn, params, batch, cfg, dctx)

        def split(x):
            b = x.shape[0]
            assert b % microbatches == 0, (b, microbatches)
            return x.reshape(microbatches, b // microbatches, *x.shape[1:])

        parts = {k: split(v) for k, v in batch.items()}
        # accumulate in the parameter dtype, as JAX does (a bf16 model's
        # f32 accumulator would double gradient memory); f32 params keep
        # f32 accumulation
        acc = tree_lib.tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                      device=p.device), params)
        metrics = None
        for i in range(microbatches):
            grads, metrics = value_and_grad(loss_fn, params,
                                            {k: v[i] for k, v in parts.items()}, cfg,
                                            dctx)
            acc = tree_lib.tree_map(lambda a, g: a + g.to(a.dtype), acc, grads)
            del grads
        return tree_lib.tree_map(lambda g: g / microbatches, acc), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = compute_grads(params, batch)
        if grad_compression == "int8":
            grads = comp_lib.fake_int8_roundtrip(grads)
        new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, metrics

    return train_step


def make_serve_step(cfg, family: str, dctx=None) -> Callable:
    """Forward-only scoring step: recsys ``serve(params, {"ids": (B, F)})``
    -> click probabilities (B,); gnn ``serve(params, {"x": (n, d),
    "edges": (2, E)})`` -> logits (n, num_classes)."""
    if family == "recsys":
        def serve(params, batch):
            with torch.inference_mode():
                return torch.sigmoid(recsys_forward(params, batch["ids"], cfg, dctx))
    elif family == "gnn":
        def serve(params, batch):
            with torch.inference_mode():
                return gcn_forward(params, batch["x"], batch["edges"], cfg, dctx)
    else:
        raise KeyError(f"no serve step for family {family!r}")
    return serve


def make_retrieval_step(cfg, dctx=None, *, k: int = 100) -> Callable:
    """recsys retrieval_cand: ``retrieve(params, {"ids": (B, F),
    "candidates": (N, D)})`` -> (scores (B, k), ids (B, k))."""

    def retrieve(params, batch):
        with torch.inference_mode():
            u = user_embedding(params, batch["ids"], cfg, dctx)
            return retrieval_score(u, batch["candidates"], k=k, dctx=dctx)

    return retrieve


def make_decode_step(cfg, dctx=None, *, mla_absorb: bool = False) -> Callable:
    """LM decode: ``decode(params, cache, tokens (B, 1), pos) ->
    (next tokens (B,) int32, cache)``, one greedy token for every sequence
    in the batch, the cache written in place; MLA models attend naively or,
    with ``mla_absorb``, through the latent cache."""

    def decode(params, cache, tokens, pos):
        with torch.inference_mode():
            logits, cache = lm_decode_step(params, cache, tokens, pos, cfg, dctx,
                                           mla_absorb=mla_absorb)
            return greedy(logits), cache

    return decode


def make_prefill_step(cfg, dctx=None, *, max_len: Optional[int] = None) -> Callable:
    """LM prefill: ``prefill(params, tokens (B, S)) -> (last logits (B, 1,
    V), cache padded to max_len)``."""

    def prefill(params, tokens):
        with torch.inference_mode():
            return lm_prefill(params, tokens, cfg, dctx, max_len=max_len)

    return prefill
