"""GCN (Kipf & Welling 2017) with edge-list message passing — port of
``repro/models/gnn.py`` on one device.

Message passing is an edge-index gather and an ``index_add`` scatter over
``dst`` (JAX's ``segment_sum``): the SpMM ``Ã X W`` in scatter form, with
the symmetric normalisation ``rsqrt(deg[src] * deg[dst])`` per edge (GCN's
sym norm; self-loops are the data pipeline's).  ``deg`` is the in-degree
over valid edges, clamped at 1; -1 edge padding (the sampler's static
shapes) is masked.  On the card ``index_add`` sums with atomics, in
another order than the CPU.

Three input regimes (the assigned shapes):
  full    — one (n_nodes, d) graph, edges (2, E)
  sampled — fanout-sampled subgraph batches from the host-side neighbour
            sampler (``models/sampler.py``), padded to static shapes
  batched — many small graphs packed into one with offset node ids

Parameters are a tree ``{"layers": [{"w" (d_in, d_out), "b"}, ...]}`` in
JAX's layouts: a plain dict, or a ``GCNModel``, which holds the same tree
as an ``nn.Module``.  The gradient is autograd's through the gather and
the scatter; no kernel lies on this path.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import DistCtx, act
from repro_torch.models import params as params_lib
from repro_torch.models.params import Param

PyTree = Any


def gcn_decls(cfg: GNNConfig, d_feat: int) -> dict:
    dims = (d_feat,) + (cfg.d_hidden,) * (cfg.num_layers - 1) + (cfg.num_classes,)
    return {
        "layers": [
            {
                "w": Param((dims[i], dims[i + 1]), ("feat", "hidden")),
                "b": Param((dims[i + 1],), ("hidden",), init="zeros"),
            }
            for i in range(cfg.num_layers)
        ]
    }


def gcn_conv(
    x: torch.Tensor,
    edges: torch.Tensor,  # (2, E) int [src, dst]; may contain -1 padding
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    n_nodes: int,
    norm: str = "sym",
    aggregator: str = "mean",
    dctx: Optional[DistCtx] = None,
) -> torch.Tensor:
    src, dst = edges[0].long(), edges[1].long()
    valid = (src >= 0) & (dst >= 0)
    src = src.clamp_min(0)
    dst = dst.clamp_min(0)
    h = x @ w + b  # transform first: (n, d_out), d_out <= d_in for GCN

    ones = valid.to(h.dtype)
    deg = torch.zeros(n_nodes, dtype=h.dtype, device=h.device).index_add(0, dst, ones)
    deg = deg.clamp_min(1.0)
    if norm == "sym":
        coef = torch.rsqrt(deg[src] * deg[dst]) * ones
    elif aggregator == "mean":
        coef = (1.0 / deg[dst]) * ones
    else:
        coef = ones
    msgs = h[src] * coef[:, None]
    return torch.zeros((n_nodes, h.shape[1]), dtype=h.dtype,
                       device=h.device).index_add(0, dst, msgs)


def gcn_forward(
    params: PyTree,
    x: torch.Tensor,
    edges: torch.Tensor,
    cfg: GNNConfig,
    dctx: Optional[DistCtx] = None,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Full-graph / subgraph forward -> (n_nodes, num_classes) logits.
    Dropout runs only in training and only when a ``generator`` is given
    (JAX's: only with an rng; its train step passes none)."""
    n = x.shape[0]
    edges = act(dctx, edges, None, "edges")
    h = x
    layers = params["layers"]
    for i, layer in enumerate(layers):
        h = gcn_conv(h, edges, layer["w"], layer["b"], n_nodes=n, norm=cfg.norm,
                     aggregator=cfg.aggregator, dctx=dctx)
        if i < len(layers) - 1:
            h = torch.relu(h)
            if train and cfg.dropout > 0 and generator is not None:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - cfg.dropout
                h = torch.where(keep, h / (1.0 - cfg.dropout), 0.0)
    return h


def gcn_loss(
    params: PyTree, batch: dict, cfg: GNNConfig, dctx: Optional[DistCtx] = None, *,
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, dict]:
    """batch: x (n, d), edges (2, E), labels (n,), optional label_mask (n,).
    The masked mean NLL and the masked accuracy."""
    logits = gcn_forward(params, batch["x"], batch["edges"], cfg, dctx,
                         train=generator is not None, generator=generator)
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        loss = nll.mean()
    acc_mask = torch.ones_like(nll) if mask is None else mask
    hit = (logits.argmax(-1) == labels).to(nll.dtype)
    acc = (hit * acc_mask).sum() / acc_mask.sum().clamp_min(1.0)
    return loss, {"loss": loss, "acc": acc}


class GCNModel(params_lib.TreeModule):
    """The parameters of one GCN (``layers.<i>.w`` / ``.b``, JAX's shapes);
    ``model(x, edges)`` is ``gcn_forward``; ``.tree()`` gives the plain
    tree."""

    def __init__(self, cfg: GNNConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def build(cls, cfg: GNNConfig, d_feat: int, *, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> "GCNModel":
        """Fresh weights for ``cfg`` over ``d_feat`` input features on
        ``device`` (default CUDA), drawn from ``generator`` (default: one
        on ``device`` seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return cls(cfg, params_lib.init_params(gcn_decls(cfg, d_feat),
                                               generator=generator, device=dev))

    def forward(self, x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
        return gcn_forward(self, x, edges, self.cfg)
