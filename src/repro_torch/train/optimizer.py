"""AdamW with global-norm clipping — port of ``repro.train.optimizer``'s
``clip_by_global_norm`` and ``adamw``.

Plain functions over lists of tensors, not ``torch.optim.AdamW``: the JAX
optimizer clips the global gradient norm at 1.0 before the moment update
and applies decoupled weight decay inside the step size, and this keeps
that order exactly.  The step counter lives on the host and the bias
corrections are computed in float32, as JAX computes them, so a step makes
no host-device round trip.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: int
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[list[torch.Tensor]], AdamWState]
    update: Callable[[list[torch.Tensor], AdamWState, list[torch.Tensor]],
                     tuple[list[torch.Tensor], AdamWState]]


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def clip_by_global_norm(
    grads: list[torch.Tensor], max_norm: float
) -> tuple[list[torch.Tensor], torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return [g * scale for g in grads], norm


def adamw(
    lr: Union[float, Callable[[int], float]] = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    def init(params: list[torch.Tensor]) -> AdamWState:
        return AdamWState(
            step=0,
            mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            nu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
        )

    def update(grads, state: AdamWState, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = float(np.float32(lr(step) if callable(lr) else lr))
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            new_p.append((p.float() - lr_t * delta).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return new_p, AdamWState(step=step, mu=new_m, nu=new_v)

    return Optimizer(init=init, update=update)
