"""Predicate AST -> per-query candidate masks — port of ``repro.core.filter``.

A predicate is a subset of the corpus, so the whole subsystem reduces to a
``(n,)`` bool mask that every engine ANDs into its candidate validity (the
scan's ``valid``, IVF list padding, the NSW result buffer):

* **AST** — ``Filter`` is an AND of ``Clause``s with three ops: ``range``
  (inclusive lo <= v <= hi, either side open), ``eq`` and ``isin``.
  ``Filter.from_spec`` accepts the dict form (``{"shop": {"isin": ["a",
  "b"]}, "price": {"range": [0, 10]}}``, a bare scalar meaning ``eq``, a
  bare list meaning ``isin``) and normalises it to hashable tuples, so
  compiled masks cache per filter.
* **compile_mask** — clause-by-clause evaluation against an
  ``AttributeStore``'s device columns, AND-reduced.  NaN / code -1 fail
  every clause; categorical values are encoded through the vocabulary on
  the host (an unknown label matches nothing).
* **resolve_mask** — the one entry point engines call: predicate or raw
  bool mask (numpy or torch) in, ``Optional[(n,) bool]`` tensor on the
  engine's device out.
* **selectivity** — the passing fraction; the infinity engine scales its
  rerank width by it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.core import attrs as attrs_lib

OPS = ("range", "eq", "isin")


@dataclasses.dataclass(frozen=True)
class Clause:
    """One column constraint.  ``value``: range -> (lo, hi) with None = open
    side; eq -> scalar; isin -> tuple of scalars / labels."""

    col: str
    op: str
    value: Any

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown filter op {self.op!r}; have {OPS}")
        if self.op == "range":
            lo, hi = self.value  # malformed ranges fail here, not at compile
            if lo is None and hi is None:
                raise ValueError(f"range on {self.col!r}: both sides open")


@dataclasses.dataclass(frozen=True)
class Filter:
    """AND of clauses — hashable, so stores can cache compiled masks."""

    clauses: tuple[Clause, ...]

    @classmethod
    def from_spec(cls, spec) -> "Filter":
        """Normalise any accepted predicate form: a ``Filter`` (as is), a
        ``Clause`` or a list of them, or a dict ``{"col": scalar}`` (eq),
        ``{"col": [v1, v2]}`` (isin), ``{"col": {"range": [lo, hi]}}`` /
        ``{"eq": v}`` / ``{"isin": [...]}``."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, Clause):
            return cls((spec,))
        if isinstance(spec, (list, tuple)) and all(isinstance(c, Clause) for c in spec):
            if not spec:  # vacuous all(): an empty list must not slip by
                raise ValueError("empty filter spec: pass filter=None to disable")
            return cls(tuple(spec))
        if not isinstance(spec, Mapping):
            raise TypeError(f"filter spec must be a Filter, Clause list, or dict: {spec!r}")
        clauses = []
        for col, cond in spec.items():
            if isinstance(cond, Mapping):
                if len(cond) != 1:
                    raise ValueError(f"filter[{col!r}]: one op per clause, got {sorted(cond)}")
                (op, val), = cond.items()
                if op == "range":
                    lo, hi = val
                    val = (_scalar(lo), _scalar(hi))
                elif op == "isin":
                    val = tuple(_scalar(v) for v in val)
                elif op == "eq":
                    val = _scalar(val)
                else:
                    raise ValueError(f"filter[{col!r}]: unknown op {op!r}; have {OPS}")
                clauses.append(Clause(col, op, val))
            elif isinstance(cond, (list, tuple, set, frozenset, np.ndarray)):
                clauses.append(Clause(col, "isin", tuple(_scalar(v) for v in cond)))
            else:
                clauses.append(Clause(col, "eq", _scalar(cond)))
        if not clauses:
            raise ValueError("empty filter spec: pass filter=None to disable")
        return cls(tuple(clauses))


def _scalar(v):
    """Hashable host scalar (numpy scalars -> python); None passes."""
    if isinstance(v, np.generic):
        return v.item()
    return v


def _f32(v) -> float:
    """``v`` rounded to float32, as the JAX clause compares ``jnp.float32(v)``."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------

def compile_mask(filt: Filter, store: attrs_lib.AttributeStore, device) -> torch.Tensor:
    """The AND of the clauses over the store's columns on ``device``: a
    ``(n,)`` bool tensor (n = the store's rows)."""
    mask = None
    for cl in filt.clauses:
        kind = store.kind(cl.col)  # unknown columns raise here
        col = store.device_columns(device)[cl.col]
        m = (_numeric_clause(cl, col) if kind == "numeric"
             else _categorical_clause(cl, col, store))
        mask = m if mask is None else mask & m
    return mask


def _numeric_clause(cl: Clause, col: torch.Tensor) -> torch.Tensor:
    if cl.op == "range":
        lo, hi = cl.value
        m = ~torch.isnan(col)  # an open side must not let NaN through
        if lo is not None:
            m = m & (col >= _f32(lo))
        if hi is not None:
            m = m & (col <= _f32(hi))
        return m
    if cl.op == "eq":
        if cl.value is None:  # the missing sentinel matches nothing
            return torch.zeros_like(col, dtype=torch.bool)
        return col == _f32(cl.value)
    m = torch.zeros_like(col, dtype=torch.bool)
    for v in cl.value:
        if v is not None:
            m = m | (col == _f32(v))
    return m


def _categorical_clause(cl: Clause, codes: torch.Tensor,
                        store: attrs_lib.AttributeStore) -> torch.Tensor:
    if cl.op == "range":
        raise TypeError(f"range clause on categorical column {cl.col!r}")
    values = (cl.value,) if cl.op == "eq" else tuple(cl.value)
    # host-side encode: unknown labels (-1) are dropped, so only real codes
    # are compared and missing rows (code -1) never match
    enc = [c for c in (store.encode(cl.col, v) for v in values) if c >= 0]
    m = torch.zeros_like(codes, dtype=torch.bool)
    for c in enc:
        m = m | (codes == c)
    return m


# ---------------------------------------------------------------------------
# the engine entry point
# ---------------------------------------------------------------------------

MaskOrSpec = Union[None, Filter, Clause, Mapping, list, tuple, np.ndarray, torch.Tensor]


def resolve_mask(filt: MaskOrSpec, store: Optional[attrs_lib.AttributeStore], n: int,
                 device) -> Optional[torch.Tensor]:
    """Predicate spec or raw bool mask -> ``(n,)`` bool tensor on the
    engine's ``device`` (None = unfiltered).

    A raw numpy or torch ``(n,)`` mask passes straight through.  Predicates
    need the engine to hold an ``AttributeStore`` (the ``attrs`` cfg key at
    build) and compile once per distinct filter and device."""
    if filt is None:
        return None
    device = torch.device(device)
    if isinstance(filt, (np.ndarray, torch.Tensor)):
        if filt.ndim != 1 or filt.shape[0] != n:
            raise ValueError(f"filter mask shape {tuple(filt.shape)} != corpus rows ({n},)")
        return torch.as_tensor(filt, device=device).to(torch.bool)
    if store is None:
        raise TypeError(
            "this index has no attribute store: build it with an 'attrs' cfg "
            "mapping (or pass a precomputed (n,) bool mask)")
    f = Filter.from_spec(filt)
    cached = store.mask_cache.get((f, device))
    if cached is None:
        cached = store.mask_cache[(f, device)] = compile_mask(f, store, device)
    if cached.shape[0] < n:
        raise ValueError(f"attribute store covers {cached.shape[0]} rows < corpus {n}")
    return cached[:n] if cached.shape[0] > n else cached


def selectivity(mask: torch.Tensor) -> float:
    """The passing fraction of a mask (one host sync): the f32 count times
    the f32 reciprocal of n, as XLA evaluates the JAX package's mean."""
    return float(mask.float().sum() * float(np.float32(1.0) / np.float32(mask.shape[0])))


def cached_selectivity(filt: MaskOrSpec, store: Optional[attrs_lib.AttributeStore],
                       mask: torch.Tensor) -> float:
    """``selectivity(mask)``, cached beside the compiled mask when the
    filter is a predicate resolved through ``store``: the host syncs once
    per distinct predicate, not once per call.  Raw masks carry no
    cacheable identity and pay per call."""
    if store is None or filt is None or isinstance(filt, (np.ndarray, torch.Tensor)):
        return selectivity(mask)
    f = Filter.from_spec(filt)
    sel = store.sel_cache.get(f)
    if sel is None:
        sel = store.sel_cache[f] = selectivity(mask)
    return sel


def bucket_selectivity(sel: float, floor: float = 1e-4) -> float:
    """Selectivity rounded DOWN to a power of two in [floor, 1] (only ever
    widens what is derived from it)."""
    if sel >= 1.0:
        return 1.0
    return 2.0 ** math.floor(math.log2(max(sel, floor)))


def scaled_width(K: int, sel: float, n: int) -> int:
    """Selectivity-scaled two-stage rerank width of the infinity engine:
    ~K / sel candidates, rounded up to a power of two, clamped to [K, n]."""
    from repro_torch.core.scan import pow2ceil

    if sel <= 0.0:
        return min(n, max(K, 1))
    want = int(np.ceil(K / max(sel, 1.0 / max(n, 1))))
    return max(K, min(n, pow2ceil(want)))
