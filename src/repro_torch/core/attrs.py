"""Columnar attribute store: per-row metadata for filtered search — port of
``repro.core.attrs``.

Named columns aligned with corpus rows, two kinds only:

* **numeric** — one float32 value per row.  Missing values are NaN, and NaN
  compares false under every clause, so unattributed rows never pass a
  numeric filter.
* **categorical** — one int32 vocabulary code per row plus the vocabulary
  (a host list of labels, insertion-ordered so snapshots are
  deterministic).  Missing values are code -1, which no label maps to.

Columns live as host numpy arrays (mutations write rows in place); the
device mirror is built lazily by ``device_columns(device)`` and dropped on
every mutation, together with the compiled-mask and selectivity caches
``core/filter`` keeps here, so a serving loop re-evaluating one filter
uploads and compiles once.  ``place`` checks and records the sharded
engine's row layout; the sharded engine hands each shard its rows of a
compiled mask as a view.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

#: numpy kinds stored as numeric float32 columns; everything else (strings,
#: objects, bools) becomes a categorical vocabulary
_NUMERIC_KINDS = ("i", "u", "f")


@dataclasses.dataclass
class AttributeStore:
    """Named per-row columns: ``numeric[name] -> (cap,) f32`` host array,
    ``categorical[name] -> ((cap,) i32 codes, vocab list)``."""

    numeric: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    categorical: dict[str, tuple[np.ndarray, list]] = dataclasses.field(
        default_factory=dict)
    #: (device, {name: column tensor}) — the device mirror, rebuilt lazily
    _dev: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: compiled masks by (Filter, device) and passing fractions by Filter
    mask_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    sel_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    #: (shards, shard_size) once ``place`` put the store over row shards
    layout: Optional[tuple[int, int]] = dataclasses.field(default=None, repr=False)

    # ------------------------------------------------------------------ build
    @classmethod
    def build(cls, values: Mapping[str, Sequence], n: int) -> "AttributeStore":
        """One store from ``{column: per-row values}``: every sequence has
        exactly ``n`` entries; int / float sequences become numeric
        columns, anything else a vocabulary in first-appearance order
        (``None`` is the missing sentinel, never a label)."""
        store = cls()
        for name, vals in dict(values or {}).items():
            _check_name(name)
            arr = np.asarray(vals)
            if arr.ndim != 1 or arr.shape[0] != n:
                raise ValueError(
                    f"attrs[{name!r}]: need {n} per-row values, got shape {arr.shape}")
            if arr.dtype.kind in _NUMERIC_KINDS:
                store.numeric[name] = arr.astype(np.float32)
            else:
                codes = np.empty((n,), np.int32)
                vocab: list = []
                _encode_into(codes, 0, arr.tolist(), vocab)
                store.categorical[name] = (codes, vocab)
        return store

    # -------------------------------------------------------------- accessors
    @property
    def n(self) -> int:
        for col in self.numeric.values():
            return int(col.shape[0])
        for codes, _ in self.categorical.values():
            return int(codes.shape[0])
        return 0

    def columns(self) -> tuple[str, ...]:
        return tuple(sorted((*self.numeric, *self.categorical)))

    def kind(self, name: str) -> str:
        if name in self.numeric:
            return "numeric"
        if name in self.categorical:
            return "categorical"
        raise KeyError(f"unknown attribute column {name!r}; have {list(self.columns())}")

    def encode(self, name: str, value) -> int:
        """Categorical label -> vocabulary code (-1 = never matches)."""
        _, vocab = self.categorical[name]
        try:
            return vocab.index(value)
        except ValueError:
            return -1

    def invalidate(self) -> None:
        self._dev = None
        self.mask_cache.clear()
        self.sel_cache.clear()

    def place(self, shards: int, shard_size: int) -> None:
        """Record the sharded engine's row layout: ``shards`` consecutive
        slices of ``shard_size`` rows, all on one device (the JAX package
        pins the columns on a mesh's data axis instead)."""
        if shards * shard_size != self.n:
            raise ValueError(f"place: {shards} x {shard_size} rows != {self.n}")
        self.layout = (int(shards), int(shard_size))

    def device_columns(self, device) -> dict[str, torch.Tensor]:
        """{name: (cap,) tensor on ``device``} — f32 for numeric, int32
        codes for categorical — uploaded once per mutation (and device),
        not per query."""
        device = torch.device(device)
        if self._dev is None or self._dev[0] != device:
            cols = {name: torch.as_tensor(col, device=device)
                    for name, col in self.numeric.items()}
            cols.update({name: torch.as_tensor(codes, device=device)
                         for name, (codes, _) in self.categorical.items()})
            self._dev = (device, cols)
        return self._dev[1]

    # -------------------------------------------------------------- mutation
    def validate_rows(self, values: Optional[Mapping[str, Sequence]], count: int) -> None:
        """Raise on unknown column names or wrong per-row value counts —
        callable before any destructive step."""
        for name, vals in dict(values or {}).items():
            if name not in self.numeric and name not in self.categorical:
                raise KeyError(f"upsert attrs: unknown column {name!r}; have "
                               f"{list(self.columns())}")
            if len(np.atleast_1d(np.asarray(vals))) != count:
                raise ValueError(f"upsert attrs[{name!r}]: need {count} values")

    def set_rows(self, start: int, values: Optional[Mapping[str, Sequence]],
                 count: int) -> None:
        """Write ``count`` rows at ``start``.  Columns absent from
        ``values`` (and ``None`` entries) get the missing sentinel; unknown
        column names raise; new labels extend the vocabulary in place."""
        values = dict(values or {})
        self.validate_rows(values, count)
        for name, col in self.numeric.items():
            col[start:start + count] = (np.asarray(values[name], np.float32)
                                        if name in values else np.nan)
        for name, (codes, vocab) in self.categorical.items():
            if name in values:
                _encode_into(codes, start, np.asarray(values[name]).tolist(), vocab)
            else:
                codes[start:start + count] = -1
        self.invalidate()

    def take(self, idx, *, capacity: Optional[int] = None) -> "AttributeStore":
        """Row-gathered copy, padded with missing sentinels up to
        ``capacity`` rows."""
        idx = np.asarray(idx, np.int64)
        pad = 0 if capacity is None else int(capacity) - idx.shape[0]
        if pad < 0:
            raise ValueError(f"take: capacity {capacity} < {idx.shape[0]} rows")
        out = AttributeStore()
        for name, col in self.numeric.items():
            out.numeric[name] = np.concatenate([col[idx], np.full((pad,), np.nan, np.float32)])
        for name, (codes, vocab) in self.categorical.items():
            out.categorical[name] = (
                np.concatenate([codes[idx], np.full((pad,), -1, np.int32)]), list(vocab))
        return out

    def to_values(self, idx=None) -> dict:
        """The inverse of ``build``: {column: host per-row values},
        optionally row-gathered by ``idx`` (missing -> None / NaN)."""
        out: dict = {}
        sel = None if idx is None else np.asarray(idx, np.int64)
        for name, col in self.numeric.items():
            out[name] = col if sel is None else col[sel]
        for name, (codes, vocab) in self.categorical.items():
            c = codes if sel is None else codes[sel]
            out[name] = [vocab[int(j)] if j >= 0 else None for j in c]
        return out

    def memory_bytes(self) -> int:
        total = sum(c.nbytes for c in self.numeric.values())
        total += sum(codes.nbytes for codes, _ in self.categorical.values())
        return int(total)

    # -------------------------------------------------------------- snapshot
    def snapshot_state(self) -> tuple[dict, dict]:
        """(arrays, statics) as the JAX store gives them."""
        arrays = {f"num_{k}": v for k, v in self.numeric.items()}
        arrays.update({f"cat_{k}": codes for k, (codes, _) in self.categorical.items()})
        statics = {
            "numeric": sorted(self.numeric),
            "categorical": {k: list(vocab) for k, (_, vocab) in self.categorical.items()},
        }
        return arrays, statics

    @classmethod
    def from_snapshot(cls, arrays: dict, statics: dict) -> "AttributeStore":
        store = cls()
        for name in statics["numeric"]:
            store.numeric[name] = np.asarray(arrays[f"num_{name}"], np.float32)
        for name, vocab in statics["categorical"].items():
            store.categorical[name] = (np.asarray(arrays[f"cat_{name}"], np.int32),
                                       list(vocab))
        return store


def _encode_into(codes: np.ndarray, start: int, labels: list, vocab: list) -> None:
    """Write the codes of ``labels`` at ``codes[start:]``, extending
    ``vocab`` with unseen labels in order; ``None`` -> -1."""
    seen = {v: i for i, v in enumerate(vocab)}
    for j, v in enumerate(labels):
        if v is None:
            codes[start + j] = -1
            continue
        code = seen.get(v)
        if code is None:
            code = seen[v] = len(vocab)
            vocab.append(v)
        codes[start + j] = code


def _check_name(name: str) -> None:
    if not isinstance(name, str) or not name:
        raise ValueError(f"attribute column names must be non-empty str: {name!r}")
    if "/" in name:
        # snapshot arrays flatten to /-joined npz keys
        raise ValueError(f"attribute column names may not contain '/': {name!r}")
