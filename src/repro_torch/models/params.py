"""Parameter declarations (port of ``repro/models/params.py``).

Models declare their parameters as a tree (dicts and lists) of ``Param``
records: shape, logical axis names and initializer.  ``init_params``
materialises the tree with an explicit ``torch.Generator`` on the device;
``param_count`` / ``param_bytes`` read the declarations alone.  The
abstract (dry-run) and sharding views wait for the port's ``dist/``.

The two frameworks draw different numbers from one seed: parity tests
initialise in JAX and load the weights (``convert.recsys_params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Param:
    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]  # one name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None  # fan-in override for 'normal'
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _fan_in(shape: tuple[int, ...]) -> int:
    # last dim is the output dim by convention (x @ w)
    return max(1, math.prod(shape[:-1])) if len(shape) > 1 else max(1, shape[0])


def is_param(x: Any) -> bool:
    return isinstance(x, Param)


def leaves(decls: PyTree) -> list[tuple[str, Param]]:
    """(dotted path, Param) for every leaf, in JAX's flattening order
    (dict keys sorted, lists in order)."""
    out: list[tuple[str, Param]] = []

    def walk(node, path):
        if is_param(node):
            out.append((path, node))
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}.{key}" if path else key)
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, f"{path}.{i}")
        else:
            raise TypeError(f"not a declaration: {node!r}")

    walk(decls, "")
    return out


def map_decls(fn: Callable[[str, Param], Any], decls: PyTree, path: str = "") -> PyTree:
    """The declaration tree with every leaf replaced by ``fn(path, param)``."""
    if is_param(decls):
        return fn(path, decls)
    if isinstance(decls, dict):
        return {key: map_decls(fn, decls[key], f"{path}.{key}" if path else key)
                for key in decls}
    return [map_decls(fn, child, f"{path}.{i}") for i, child in enumerate(decls)]


def _init_leaf(p: Param, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, p.dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        scale = 0.02
    else:
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(_fan_in(p.shape))
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def init_params(decls: PyTree, *, generator: torch.Generator,
                device: torch.device) -> PyTree:
    """The declaration tree materialised on ``device``: normal leaves drawn
    from ``generator`` (which must live on ``device``) in JAX's leaf order,
    scaled by ``Param.scale`` or 1/sqrt(fan-in)."""
    drawn = {path: _init_leaf(p, generator, device) for path, p in leaves(decls)}
    return map_decls(lambda path, _: drawn[path], decls)


def param_count(decls: PyTree) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(decls))


def param_bytes(decls: PyTree) -> int:
    return sum(math.prod(p.shape) * np.dtype(p.dtype).itemsize for _, p in leaves(decls))
