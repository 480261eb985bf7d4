"""Index protocol and registry — the part of ``repro.core.index`` this
slice needs: ``SearchResult``, ``register_index``, ``build`` and
``resolve``.  The reserved cfg keys ``attrs``, ``quant`` and ``chaos``
(attribute filters, the int8 store, fault injection) and ``ShardedIndex``
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch.device import DeviceLike


class SearchResult(NamedTuple):
    """Uniform search answer: unpacks as (idx, dist, comparisons)."""

    idx: torch.Tensor  # (B, k) int32, -1 = no result
    dist: torch.Tensor  # (B, k) f32, ascending (ties -> lowest index)
    comparisons: torch.Tensor  # (B,) int32 distance evaluations


_REGISTRY: dict[str, type] = {}
RESERVED = ("attrs", "quant", "chaos")


def register_index(name: str):
    """Class decorator: expose an engine under a stable string key."""

    def deco(cls):
        for attr in ("build", "search"):
            if not hasattr(cls, attr):
                raise TypeError(f"{cls.__name__} lacks Index.{attr}")
        cls.registry_name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtin() -> None:
    # engines self-register at module load
    import repro_torch.core.search  # noqa: F401


def available() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def get_index(name: str) -> type:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown index {name!r}; available: {available()}") from None


def build(name: str, X, cfg: Optional[Mapping[str, Any]] = None, *,
          device: DeviceLike = None):
    """Build a registered engine from one config mapping on ``device``
    (default CUDA).  Keys the engine's build does not take become its
    search defaults (the engine's ``registry_build`` splits them)."""
    cls = get_index(name)
    cfg = dict(cfg or {})
    for key in RESERVED:
        if cfg.get(key) is not None:
            raise NotImplementedError(
                f"registry key {key!r} is not ported to repro_torch yet"
            )
    return cls.registry_build(X, cfg, device=device)


def resolve(value, defaults: Optional[Mapping[str, Any]], key: str, fallback=None):
    """Search-kwarg resolution order: explicit arg > stored default > fallback."""
    if value is not None:
        return value
    if defaults and defaults.get(key) is not None:
        return defaults[key]
    return fallback
