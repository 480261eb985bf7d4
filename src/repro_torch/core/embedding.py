"""Embedding operator Phi (paper §4, App. F.3) — port of
``repro.core.embedding``.

An MLP ``Phi: R^n -> R^s`` trained so Euclidean distances in the embedding
approximate the canonical q-metric distances (stress loss, Eq. 14, plus an
optional q-triangle penalty, Eq. 72), with AdamW over sampled pairs.  Pairs
whose projected distance is +inf are masked out of the loss.

Phi is an ``nn.Module``: Linear -> GELU -> Dropout blocks and a final
Linear.  The JAX package keeps each weight as (din, dout); here it is the
transposed ``nn.Linear.weight``.  Two reference semantics differ from the
PyTorch defaults and are reproduced: ``jax.nn.gelu`` is the tanh form, and
``jnp.nanmedian`` averages the two middle values (``nanmedian`` below).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    in_dim: int
    out_dim: int = 32
    hidden: tuple[int, ...] = (256, 256)
    dropout: float = 0.05
    # training
    q: float = math.inf
    lr: float = 1e-3
    steps: int = 1500
    batch_pairs: int = 1024
    batch_triplets: int = 256
    alpha_d: float = 1.0
    alpha_t: float = 0.0
    seed: int = 0
    local_frac: float = 0.5
    weight: str = "sammon"  # 'none' reproduces the paper's Eq. 14 exactly


class Phi(nn.Module):
    """The embedding MLP, with the input normalisers and the target scale
    the trainer attaches as buffers (``x_mean`` / ``x_std`` standardise the
    input in ``forward``; ``d_scale`` is kept for reference)."""

    def __init__(self, dims: tuple[int, ...]):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(din, dout) for din, dout in zip(dims[:-1], dims[1:])
        )
        self.register_buffer("x_mean", None)
        self.register_buffer("x_std", None)
        self.register_buffer("d_scale", None)

    def forward(self, x: torch.Tensor, *, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _mlp(x, [(layer.weight, layer.bias) for layer in self.layers],
                    self.x_mean, self.x_std, dropout=dropout, generator=generator)


def _mlp(x: torch.Tensor, layers, x_mean: Optional[torch.Tensor],
         x_std: Optional[torch.Tensor], *, dropout: float = 0.0,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Phi's layer math, the one copy: standardise by ``x_mean`` / ``x_std``
    (when set), then ``F.linear`` over ``layers`` of (weight (dout, din),
    bias) with tanh-GELU and, while training, dropout between them."""
    h = x if x_mean is None else (x - x_mean) / x_std
    last = len(layers) - 1
    for i, (w, b) in enumerate(layers):
        h = F.linear(h, w, b)
        if i < last:
            h = F.gelu(h, approximate="tanh")
            if dropout > 0.0 and generator is not None:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - dropout
                h = torch.where(keep, h / (1.0 - dropout), 0.0)
    return h


def init_phi(cfg: EmbedConfig, generator: torch.Generator,
             device: torch.device) -> Phi:
    """N(0, 1/din) weights (drawn as the JAX (din, dout) layout, stored
    transposed), zero biases."""
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.out_dim,)
    phi = Phi(dims).to(device)
    with torch.no_grad():
        for layer, din in zip(phi.layers, dims[:-1]):
            w = torch.randn((din, layer.out_features), generator=generator,
                            device=device) * (1.0 / math.sqrt(din))
            layer.weight.copy_(w.T)
            layer.bias.zero_()
    return phi


def apply(phi: Phi, x: torch.Tensor) -> torch.Tensor:
    """Phi(x): (..., in_dim) -> (..., out_dim), without autograd."""
    with torch.no_grad():
        return phi(x.float())


def params_of(phi: Phi) -> dict:
    """Phi as the JAX package's params tree of tensors on its device:
    ``layers`` of {"w" (din, dout), "b"} plus the normalisers the trainer
    attached (``x_mean``, ``x_std``, ``d_scale``)."""
    params: dict = {"layers": [{"w": mod.weight.detach().T.contiguous(),
                                "b": mod.bias.detach().clone()} for mod in phi.layers]}
    for name in ("x_mean", "x_std", "d_scale"):
        val = getattr(phi, name)
        if val is not None:
            params[name] = val
    return params


def apply_params(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Phi(x) from a params tree in ``params_of``'s layout, without
    autograd — the form the sharded engine runs on each shard's slice of
    its stacked trees."""
    with torch.no_grad():
        return _mlp(x.float(), [(layer["w"].T, layer["b"]) for layer in params["layers"]],
                    params.get("x_mean"), params.get("x_std"))


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median ignoring NaNs, averaging the two middle values of an even
    count as ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower
    one).  NaN when every entry is NaN.  No host sync."""
    x = x.reshape(-1)
    s = torch.sort(x).values  # NaNs sort last
    cnt = (~torch.isnan(x)).sum()
    lo = (cnt - 1).clamp_min(0) // 2
    hi = torch.where(cnt % 2 == 0, lo + 1, lo).clamp_max(x.numel() - 1)
    even = (cnt % 2 == 0) & (cnt > 0)
    med = torch.where(even, s[lo] * 0.5 + s[hi] * 0.5, s[lo])
    return torch.where(cnt > 0, med, torch.full_like(med, float("nan")))


def embed_dist(phi: Phi, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    zx, zy = phi(x), phi(y)
    return torch.sqrt(((zx - zy) ** 2).sum(-1).clamp_min(1e-12))


def stress_loss(
    phi: Phi, xi: torch.Tensor, xj: torch.Tensor, dij: torch.Tensor, *,
    dropout: float = 0.0, generator: Optional[torch.Generator] = None,
    weight: str = "none",
) -> torch.Tensor:
    """Mean masked stress (Eq. 14/15); dij = +inf pairs are masked.
    weight='sammon' divides each term by (dij + median(dij))."""
    zi = phi(xi, dropout=dropout, generator=generator)
    zj = phi(xj, dropout=dropout, generator=generator)
    dhat = torch.sqrt(((zi - zj) ** 2).sum(-1).clamp_min(1e-12))
    mask = torch.isfinite(dij)
    d = torch.where(mask, dij, 0.0)
    sq = torch.where(mask, dhat - d, 0.0) ** 2
    if weight == "sammon":
        scale = nanmedian(torch.where(mask, d, float("nan")))
        sq = sq / (d + torch.nan_to_num(scale).clamp_min(1e-6))
    return sq.sum() / mask.sum().clamp_min(1)


def triangle_loss(phi: Phi, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
                  q: float) -> torch.Tensor:
    """Mean saturated q-triangle violation (Eq. 72) in a per-triplet
    normalised power domain."""
    dxy = embed_dist(phi, x, y)
    dxz = embed_dist(phi, x, z)
    dyz = embed_dist(phi, y, z)
    if math.isinf(q):
        return F.relu(dxy - torch.maximum(dxz, dyz)).mean()
    s = torch.maximum(torch.maximum(dxy, dxz), dyz.clamp_min(1e-12)).detach()
    viol = (dxy / s) ** q - (dxz / s) ** q - (dyz / s) ** q
    return F.relu(viol).mean()


def train_embedding(
    X: torch.Tensor,
    Dq: torch.Tensor,
    cfg: EmbedConfig,
    *,
    knn_idx: Optional[torch.Tensor] = None,
    log_every: int = 0,
) -> tuple[Phi, dict]:
    """Fit Phi = argmin alpha_D * stress + alpha_T * triangle (Eq. 73).

    X (n, in_dim) training vectors on the device Phi trains on; Dq (n, n)
    projected q-distances (+inf for disconnected pairs); ``knn_idx`` (n, k)
    enables locality-biased pair sampling.  Random numbers come from one
    ``torch.Generator`` seeded with ``cfg.seed`` (they differ from the JAX
    stream, so training agrees with the JAX package statistically).
    Phi carries no normalisers while it trains (they are attached at the
    end, as the JAX trainer attaches them to its params), so the losses see
    the standardised inputs directly.  Returns (phi, history)."""
    dev = X.device
    n = X.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(cfg.seed))
    phi = init_phi(cfg, gen, dev)
    # input standardisation + target scale normalisation (search is
    # invariant to a global distance scale); attached to phi afterwards
    X = X.float()
    x_mean = X.mean(0)
    x_std = X.std(0, unbiased=False).clamp_min(1e-6)
    finite = torch.isfinite(Dq) & ~torch.eye(n, dtype=torch.bool, device=dev)
    d_scale = nanmedian(torch.where(finite, Dq, float("nan")))
    d_scale = torch.nan_to_num(d_scale, nan=1.0).clamp_min(1e-9)
    Xn = (X - x_mean) / x_std
    Dn = Dq / d_scale
    params = list(phi.parameters())
    opt = opt_lib.adamw(cfg.lr, weight_decay=1e-5)
    state = opt.init(params)
    use_local = knn_idx is not None and cfg.local_frac > 0.0
    n_local = int(cfg.batch_pairs * cfg.local_frac) if use_local else 0
    bp, bt = cfg.batch_pairs, cfg.batch_triplets

    history: dict = {"loss": []}
    for t in range(cfg.steps):
        ii = torch.randint(0, n, (bp,), generator=gen, device=dev)
        jj = torch.randint(0, n, (bp,), generator=gen, device=dev)
        if n_local:
            # the first n_local js are kNN neighbours of their i
            col = torch.randint(0, knn_idx.shape[1], (n_local,), generator=gen,
                                device=dev)
            jj = torch.cat([knn_idx[ii[:n_local], col].long(), jj[n_local:]])
        kk = torch.randint(0, n, (bp,), generator=gen, device=dev)
        loss = cfg.alpha_d * stress_loss(
            phi, Xn[ii], Xn[jj], Dn[ii, jj], dropout=cfg.dropout, generator=gen,
            weight=cfg.weight,
        )
        if cfg.alpha_t > 0.0:
            loss = loss + cfg.alpha_t * triangle_loss(
                phi, Xn[ii[:bt]], Xn[jj[:bt]], Xn[kk[:bt]], cfg.q,
            )
        grads = torch.autograd.grad(loss, params)
        new_params, state = opt.update(list(grads), state, [p.detach() for p in params])
        with torch.no_grad():
            for p, newp in zip(params, new_params):
                p.copy_(newp)
        if log_every and (t % log_every == 0 or t == cfg.steps - 1):
            history["loss"].append((t, float(loss.detach())))
    phi.x_mean = x_mean
    phi.x_std = x_std
    phi.d_scale = d_scale
    return phi, history

