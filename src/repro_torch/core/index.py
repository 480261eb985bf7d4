"""Index protocol and registry — port of ``repro.core.index``:
``SearchResult``, ``register_index``, ``build`` with the reserved
``attrs``, ``quant`` and ``chaos`` keys, ``attach_store``,
``attach_quant_store``, ``attach_chaos``, ``list_engines``, the memory
audit helpers and ``resolve``.  The built-in engines are ``brute``,
``ivf_flat``, ``ivf_pq``, ``nsw`` (``core/baselines``), ``infinity``
(``core/search``) and ``live`` (``core/live``, a mutable wrapper over any
of them); each takes ``search(..., filter=)``.  ``ShardedIndex`` (the
registry key ``sharded``) is not ported yet: asking for it raises
``NotImplementedError``.
"""
from __future__ import annotations

import inspect
from typing import Any, Mapping, NamedTuple, Optional

import torch

from repro_torch.core import attrs as attrs_lib
from repro_torch.core import chaos as chaos_lib
from repro_torch.core import quant as quant_lib
from repro_torch.device import DeviceLike


class SearchResult(NamedTuple):
    """Uniform search answer: unpacks as (idx, dist, comparisons)."""

    idx: torch.Tensor  # (B, k) int32, -1 = no result
    dist: torch.Tensor  # (B, k) f32, ascending (ties -> lowest index)
    comparisons: torch.Tensor  # (B,) int32 distance evaluations


_REGISTRY: dict[str, type] = {}
BUILTIN = ("brute", "ivf_flat", "ivf_pq", "nsw", "infinity", "sharded", "live")
#: registry keys the port does not serve yet, and the ROADMAP item that
#: brings each
UNPORTED = {"sharded": "ROADMAP.md Queue 1 item 2 (ShardedIndex)"}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every not-yet-ported path raises: what, and the ROADMAP
    item that brings it."""
    return NotImplementedError(f"{what} is not ported to repro_torch yet: {item}")


def register_index(name: str):
    """Class decorator: expose an engine under a stable string key."""

    def deco(cls):
        for attr in ("build", "search", "memory_bytes"):
            if not hasattr(cls, attr):
                raise TypeError(f"{cls.__name__} lacks Index.{attr}")
        cls.registry_name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def _ensure_builtin() -> None:
    # engines self-register at module load
    import repro_torch.core.baselines  # noqa: F401
    import repro_torch.core.live  # noqa: F401
    import repro_torch.core.search  # noqa: F401


def available() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def list_engines() -> dict[str, str]:
    """{registry key: one-line summary} for every registered engine — the
    operator-facing discovery surface (``serve --list-engines``)."""
    _ensure_builtin()
    out = {}
    for name in sorted(_REGISTRY):
        doc = (_REGISTRY[name].__doc__ or "").strip()
        out[name] = doc.splitlines()[0].strip() if doc else ""
    return out


def get_index(name: str) -> type:
    _ensure_builtin()
    if name in UNPORTED:
        raise not_ported(f"the {name!r} engine", UNPORTED[name])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown index {name!r}; available: {available()}") from None


def build(name: str, X, cfg: Optional[Mapping[str, Any]] = None, *,
          device: DeviceLike = None):
    """Build a registered engine from one config mapping on ``device``
    (default CUDA).  Keys the engine's build does not take become its
    search defaults.

    The reserved key ``attrs`` — ``{column: per-row values}`` — builds a
    columnar ``core/attrs.AttributeStore`` aligned with the corpus rows and
    attaches it (``attach_store``), enabling predicate filters on every
    engine's ``search``.  It is handled here, once for every engine.

    The reserved key ``quant`` (truthy) quantizes the corpus to int8 codes
    (``core/quant.QuantStore``) and attaches the store
    (``attach_quant_store``): brute then scans codes first and reranks a
    ``quant.shortlist_width``-wide shortlist exactly; infinity scans its
    beam buckets on codes and prefilters its rerank on them; live extends
    the store to its slot capacity and quantizes upserts.

    The reserved key ``chaos`` — a ``core/chaos.FaultPlan`` or its dict
    sugar — arms deterministic fault injection: plain engines get their
    ``search`` wrapped with the latency/transient injector, live holds the
    plan and consults it at its own fault sites (compaction publish, delta
    overflow), and ``core/store.save`` consults it to corrupt a snapshot.
    A ``build``-site fault fires here, after construction: the poisoned
    instance never escapes."""
    cls = get_index(name)
    cfg = dict(cfg or {})
    attr_values = cfg.pop("attrs", None)
    quant_cfg = cfg.pop("quant", None)
    chaos_cfg = cfg.pop("chaos", None)
    hook = getattr(cls, "registry_build", None)
    if hook is not None:
        inst = hook(X, cfg, device=device)
    else:
        inst = generic_registry_build(cls, X, cfg, device=device)
    if attr_values:
        attach_store(inst, attrs_lib.AttributeStore.build(attr_values,
                                                          int(_corpus(inst).shape[0])))
    if quant_cfg:
        attach_quant_store(inst, quant_lib.QuantStore.build(_corpus(inst)))
    if chaos_cfg is not None:
        plan = chaos_lib.FaultPlan.from_cfg(chaos_cfg)
        plan.on_build()  # a poisoned build never escapes
        attach_chaos(inst, plan)
    return inst


def _corpus(inst) -> torch.Tensor:
    """The rows an engine was built over (live: its frozen segment)."""
    X = getattr(inst, "X", None)
    return X if X is not None else inst.frozen_X


def generic_registry_build(cls, X, cfg: Optional[Mapping[str, Any]], *,
                           device: DeviceLike = None):
    """Split ``cfg`` against the engine's ``build`` / ``search`` signatures:
    build keys configure construction, search keys become the instance's
    search defaults."""
    cfg = dict(cfg or {})
    bkeys = set(inspect.signature(cls.build).parameters) - {"cls", "X", "device"}
    skeys = (set(inspect.signature(cls.search).parameters) - {"self", "Q", "k"}) | {"budget"}
    bkw = {k: cfg.pop(k) for k in list(cfg) if k in bkeys}
    skw = {k: cfg.pop(k) for k in list(cfg) if k in skeys}
    if cfg:
        raise TypeError(
            f"{cls.registry_name}: unknown cfg keys {sorted(cfg)} "
            f"(build takes {sorted(bkeys)}, search takes {sorted(skeys)})"
        )
    inst = cls.build(X, device=device, **bkw)
    inst.search_defaults = skw
    return inst


def attach_store(inst, store) -> None:
    """Attach a built ``core/attrs.AttributeStore`` — through the engine's
    ``attach_attrs`` hook when it has one, else as a plain ``attrs``
    attribute."""
    hook = getattr(inst, "attach_attrs", None)
    if hook is not None:
        hook(store)
    else:
        inst.attrs = store


def attach_quant_store(inst, store) -> None:
    """Attach a built ``core/quant.QuantStore`` — through the engine's
    ``attach_quant`` hook when it has one, else as a plain ``quant``
    attribute."""
    hook = getattr(inst, "attach_quant", None)
    if hook is not None:
        hook(store)
    else:
        inst.quant = store


def attach_chaos(inst, plan) -> None:
    """Arm an engine instance with a ``core/chaos.FaultPlan`` — through its
    ``attach_chaos`` hook when it has one (live fires compaction / delta
    faults itself), else by wrapping ``search`` with the generic injector:
    every call first runs the plan's ``search`` site (latency spikes sleep,
    transient rules raise), then the engine."""
    hook = getattr(inst, "attach_chaos", None)
    if hook is not None:
        hook(plan)
        return
    inst.chaos = plan
    orig = inst.search

    def chaotic_search(*args, **kwargs):
        plan.on_search()
        return orig(*args, **kwargs)

    inst.search = chaotic_search


def pytree_nbytes(tree) -> int:
    """Bytes of every tensor in a nested structure (dicts, lists, tuples,
    ``nn.Module`` parameters and buffers); None counts 0."""
    if isinstance(tree, torch.nn.Module):
        return sum(pytree_nbytes(t) for t in
                   list(tree.parameters()) + list(tree.buffers()))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Mapping):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    return 0


def side_store_bytes(inst) -> int:
    """Bytes of the per-instance side stores (``attrs`` columns, ``quant``
    codes) — every engine's ``memory_bytes`` adds this."""
    total = 0
    for name in ("attrs", "quant"):
        store = getattr(inst, name, None)
        if store is not None:
            total += store.memory_bytes()
    return int(total)


def resolve(value, defaults: Optional[Mapping[str, Any]], key: str, fallback=None):
    """Search-kwarg resolution order: explicit arg > stored default > fallback."""
    if value is not None:
        return value
    if defaults and defaults.get(key) is not None:
        return defaults[key]
    return fallback
