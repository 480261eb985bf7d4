"""Parameter declarations (port of ``repro/models/params.py``).

Models declare their parameters as a tree (dicts and lists) of ``Param``
records: shape, logical axis names and initializer.  ``init_params``
materialises the tree with an explicit ``torch.Generator`` on the device;
``param_count`` / ``param_bytes`` read the declarations alone;
``TreeModule`` holds a materialised tree as an ``nn.Module``.  The
sharding view is ``dist/sharding.DistCtx.shard_w``; the abstract view
(``abstract_params``: meta tensors, nothing allocated) is what
``launch/cells`` and ``launch/dryrun`` run a step on.

The two frameworks draw different numbers from one seed: parity tests
initialise in JAX and load the weights (``convert.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch import nn

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


def abstract_params(decls: PyTree) -> PyTree:
    """The declaration tree as tensors on ``torch.device("meta")`` of the
    declared shapes and dtypes (JAX's ``ShapeDtypeStruct`` tree): the
    dry-run never allocates parameters."""
    return map_decls(lambda _, p: torch.empty(p.shape, dtype=getattr(torch, p.dtype),
                                              device="meta"), decls)


def logical_specs(decls: PyTree) -> PyTree:
    """Each leaf's tuple of logical axis names."""
    return map_decls(lambda _, p: p.logical, decls)


def map_with_decls(fn: Callable[[Param, Any], Any], decls: PyTree, tree: PyTree) -> PyTree:
    """``fn(param, leaf)`` over the leaves of ``tree`` (dicts and lists of
    the declarations' structure, or a ``TreeModule``), in ``decls``'
    structure."""
    if is_param(decls):
        return fn(decls, tree)
    if isinstance(decls, dict):
        if sorted(decls) != sorted(tree.keys()):
            raise ValueError(f"tree keys {sorted(tree.keys())} against {sorted(decls)}")
        return {key: map_with_decls(fn, decls[key], tree[key]) for key in decls}
    if len(decls) != len(tree):
        raise ValueError(f"tree of {len(tree)} children against {len(decls)}")
    return [map_with_decls(fn, d, t) for d, t in zip(decls, tree)]


def param_count(decls: PyTree) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(decls))


def param_bytes(decls: PyTree) -> int:
    return sum(math.prod(p.shape) * getattr(torch, p.dtype).itemsize
               for _, p in leaves(decls))


class TreeModule(nn.Module):
    """A parameter tree (dicts of tensors, dicts and lists of dicts) as an
    ``nn.Module``: a dict's tensors are parameters under their keys, its
    dicts and lists submodules, so ``named_parameters`` gives the tree's
    dotted paths (``mlp.0.w``, ``dense_blocks.attn.wq``) and
    ``module["mlp"][0]["w"]`` and ``keys()`` read as the plain tree's
    do."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value))
            elif isinstance(value, dict):
                self.add_module(name, TreeModule(value))
            else:
                self.add_module(name, nn.ModuleList(TreeModule(v) for v in value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def keys(self) -> list[str]:
        return ([name for name, _ in self.named_children()]
                + [name for name, _ in self.named_parameters(recurse=False)])

    def tree(self) -> dict:
        """The parameters as a plain tree (dicts and lists of tensors that
        share this module's storage, detached): what ``make_train_step``
        and the optimizers take."""
        out: dict = {}
        for name, child in self.named_children():
            out[name] = (child.tree() if isinstance(child, TreeModule)
                         else [layer.tree() for layer in child])
        for name, value in self.named_parameters(recurse=False):
            out[name] = value.detach()
        return out
