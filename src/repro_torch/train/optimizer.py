"""Optimizers — port of ``repro.train.optimizer``: AdamW and Adafactor over
parameter trees, SGD with momentum, global-norm clipping and the cosine /
constant schedules.

Plain functions, not ``torch.optim``: the JAX optimizers clip the global
gradient norm before the moment update and apply decoupled weight decay
inside the step size, and these keep that order exactly.  Parameters,
gradients and state are trees (``train/tree``: dicts, lists, NamedTuples
of tensors, flattened in JAX's leaf order), so the state mirrors the
parameter tree as JAX's does and a checkpoint names its leaves as JAX's.
A plain list of tensors is a tree (Phi's fit in ``core/embedding``).  The
step counter lives on the host and the schedule and bias corrections are
computed in float32 on the host, as JAX computes them, so a step makes no
host-device round trip.  Each update returns new tensors and leaves its
inputs as they were, as JAX's functions do.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.train import tree as tree_lib

Tree = Any
Schedule = Callable[[int], float]


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


class AdafactorState(NamedTuple):
    step: int
    # per leaf: {'vr': row stats, 'vc': column stats} for >= 2-D, {'v': full} below
    stats: Tree


class Optimizer(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]  # (grads, state, params)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree_lib.leaves(tensors)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: g * scale, grads), norm


def _f32(x) -> np.float32:
    return np.float32(x)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Schedule:
    """Linear warm-up over ``warmup`` steps, then a half cosine to 0 at
    ``total``; evaluated in float32 as JAX's is."""

    def f(step: int) -> float:
        s = _f32(step)
        warm = np.minimum(s / _f32(max(warmup, 1)), _f32(1.0))
        t = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                    _f32(0.0), _f32(1.0))
        return float(_f32(base_lr) * warm * _f32(0.5)
                     * (_f32(1.0) + np.cos(_f32(np.pi) * t)))

    return f


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: float(_f32(base_lr))


def _schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def adamw(
    lr: Union[float, Schedule] = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    sched = _schedule(lr)

    def init(params: Tree) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamWState(step=0, mu=tree_lib.tree_map(zeros, params),
                          nu=tree_lib.tree_map(zeros, params))

    def update(grads: Tree, state: AdamWState, params: Tree):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        lr_t = float(_f32(sched(step)))
        bc1 = float(_f32(1.0) - _f32(b1) ** _f32(step))
        bc2 = float(_f32(1.0) - _f32(b2) ** _f32(step))

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            return (p.float() - lr_t * delta).to(p.dtype), m, v

        flat_p, spec = tree_lib.flatten(params)
        out = [upd(g, m, v, p) for g, m, v, p in zip(
            tree_lib.flatten_up_to(spec, grads), tree_lib.flatten_up_to(spec, state.mu),
            tree_lib.flatten_up_to(spec, state.nu), flat_p)]
        return (tree_lib.unflatten(spec, [o[0] for o in out]),
                AdamWState(step=step, mu=tree_lib.unflatten(spec, [o[1] for o in out]),
                           nu=tree_lib.unflatten(spec, [o[2] for o in out])))

    return Optimizer(init=init, update=update)


def adafactor(
    lr: Union[float, Schedule] = 1e-2,
    *,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored second-moment optimizer: a (r, c) matrix keeps r + c
    floats of state instead of 2 r c."""
    sched = _schedule(lr)

    def init(params: Tree) -> AdafactorState:
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return AdafactorState(step=0, stats=tree_lib.tree_map(leaf, params))

    def update(grads: Tree, state: AdafactorState, params: Tree):
        step = state.step + 1
        lr_t = float(_f32(sched(step)))
        beta = _f32(1.0) - _f32(step) ** _f32(-decay)
        keep, take = float(beta), float(_f32(1.0) - beta)

        def upd(g, s, p):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if p.dim() >= 2:
                vr = keep * s["vr"] + take * g2.mean(-1)
                vc = keep * s["vc"] + take * g2.mean(-2)
                denom = vr.mean(-1, keepdim=True)
                vhat = vr[..., :, None] * vc[..., None, :] / denom[..., None].clamp_min(eps)
                u = g32 / torch.sqrt(vhat.clamp_min(eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = keep * s["v"] + take * g2
                u = g32 / torch.sqrt(v.clamp_min(eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)))
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            newp = p.float() - lr_t * (u + weight_decay * p.float())
            return newp.to(p.dtype), new_s

        flat_p, spec = tree_lib.flatten(params)
        out = [upd(g, s, p) for g, s, p in zip(
            tree_lib.flatten_up_to(spec, grads), tree_lib.flatten_up_to(spec, state.stats),
            flat_p)]
        return (tree_lib.unflatten(spec, [o[0] for o in out]),
                AdafactorState(step=step, stats=tree_lib.unflatten(spec, [o[1] for o in out])))

    return Optimizer(init=init, update=update)


def sgd(lr: Union[float, Schedule] = 1e-2, *, momentum: float = 0.0) -> Optimizer:
    """State ``(step, velocity tree)``, the velocity ``None`` without
    momentum, as JAX's tuple."""
    sched = _schedule(lr)

    def init(params: Tree):
        if momentum:
            return (0, tree_lib.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))
        return (0, None)

    def update(grads: Tree, state, params: Tree):
        step, vel = state
        step = step + 1
        lr_t = float(_f32(sched(step)))
        if momentum:
            vel = tree_lib.tree_map(lambda v, g: momentum * v + g.float(), vel, grads)
            params = tree_lib.tree_map(
                lambda p, v: (p.float() - lr_t * v).to(p.dtype), params, vel)
        else:
            params = tree_lib.tree_map(
                lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype), params, grads)
        return params, (step, vel)

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}
