"""Symmetric absmax int8 quantisation — port of ``repro.core.quant``: the
definition (``absmax_scales`` / ``encode`` / ``decode`` / ``fake_quant``),
the rerank-width rule (``shortlist_width``) and ``QuantStore``, the
engine-facing container of a corpus's codes.

``scale = max(|x|) / 127``; ``code = clip(round(x / scale), -127, 127)``
(``torch.round`` rounds half to even, as ``jnp.round`` does);
``decode = code * scale``.  ``QuantStore.place`` records the sharded
engine's row layout, and ``device_view(shard=s)`` then hands shard ``s``
its rows of the codes and sq-norms as views (the scales are shared).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: absmax floor — keeps all-zero dimensions from dividing by zero
EPS = 1e-30


def absmax_scales(x: torch.Tensor, axis=None, keepdims: bool = False) -> torch.Tensor:
    """``max(|x|) / 127`` along ``axis`` (None = whole tensor)."""
    a = x.abs()
    s = a.amax() if axis is None else a.amax(dim=axis, keepdim=keepdims)
    return s.clamp_min(EPS) / 127.0


def encode(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 codes under ``scales`` (broadcastable against ``x``)."""
    return torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)


def decode(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes -> f32 under ``scales``; max error scale/2 per entry."""
    return codes.float() * scales


def fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Whole-tensor quantize->dequantize round-trip, dtype preserved."""
    scales = absmax_scales(x)
    return decode(encode(x, scales), scales).to(x.dtype)


def shortlist_width(k: int, n: int, *, mult: int = 4, floor: int = 32) -> int:
    """How many first-stage candidates the exact rerank re-scores for a
    final top-k over n rows: ``min(n, pow2ceil(max(mult * k, floor)))``."""
    from repro_torch.core.scan import pow2ceil

    return min(int(n), pow2ceil(max(mult * int(k), floor)))


@dataclasses.dataclass
class QuantStore:
    """Per-dimension absmax int8 codes for a corpus.

    ``codes`` ``(rows, d)`` int8 and ``scales`` ``(d,)`` f32 live as host
    numpy arrays, as in the JAX package (mutations write rows in place);
    ``device_view()`` uploads them to ``device`` — with the per-row squared
    dequant norms the int8 kernel consumes — once per mutation.
    """

    codes: np.ndarray  # (rows, d) int8
    scales: np.ndarray  # (d,) f32
    device: torch.device  # where device_view() puts them
    _dev: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: (shards, shard_size) once ``place`` put the store over row shards
    layout: Optional[tuple[int, int]] = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(cls, X, *, device: DeviceLike = None) -> "QuantStore":
        """Quantize a corpus: per-dimension scales from the corpus absmax.
        A tensor stays on its device; anything else is placed on ``device``
        (default CUDA) first.  The store's views go to the same device."""
        if isinstance(X, torch.Tensor):
            X = X.float()
        else:
            X = torch.as_tensor(np.asarray(X, np.float32), device=resolve_device(device))
        scales = absmax_scales(X, axis=0)
        return cls(codes=encode(X, scales).cpu().numpy(),
                   scales=scales.cpu().numpy().astype(np.float32),
                   device=X.device)

    @property
    def rows(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dim(self) -> int:
        return int(self.codes.shape[1])

    def invalidate(self) -> None:
        self._dev = None

    def place(self, shards: int, shard_size: int) -> None:
        """Record the sharded engine's row layout: ``shards`` consecutive
        slices of ``shard_size`` rows, all on the store's one device (the
        JAX package pins the rows on a mesh's data axis instead)."""
        if shards * shard_size != self.rows:
            raise ValueError(f"place: {shards} x {shard_size} rows != {self.rows}")
        self.layout = (int(shards), int(shard_size))

    def device_view(self, shard: Optional[int] = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(codes (rows, d) int8, scales (d,) f32, sqnorms (rows,) f32) on
        the store's device — ``sqnorms[i] = sum_j (codes[i,j] * scales[j])^2``,
        the candidate-norm operand of the int8 kernel.  ``shard``: that
        shard's rows of codes and sq-norms under ``place``'s layout, as
        views, with the shared scales."""
        if self._dev is None:
            codes = torch.tensor(self.codes, device=self.device)
            scales = torch.tensor(self.scales, device=self.device)
            sqnorms = (decode(codes, scales) ** 2).sum(1)
            self._dev = (codes, scales, sqnorms)
        if shard is None:
            return self._dev
        if self.layout is None:
            raise ValueError("device_view(shard=...) needs place() first")
        codes, scales, sqnorms = self._dev
        lo = int(shard) * self.layout[1]
        hi = lo + self.layout[1]
        return codes[lo:hi], scales, sqnorms[lo:hi]

    def set_rows(self, start: int, X_rows, count: int) -> None:
        """Quantize ``count`` new rows in place at ``start`` with the
        EXISTING scales (the live upsert hook)."""
        X_rows = torch.as_tensor(np.asarray(X_rows, np.float32))
        self.codes[start:start + count] = encode(
            X_rows, torch.as_tensor(self.scales)).numpy()
        self.invalidate()

    def take(self, idx, *, capacity: Optional[int] = None) -> "QuantStore":
        """Row-gathered copy under the same scales, zero-padded up to
        ``capacity`` rows."""
        idx = np.asarray(idx, np.int64)
        pad = 0 if capacity is None else int(capacity) - idx.shape[0]
        if pad < 0:
            raise ValueError(f"take: capacity {capacity} < {idx.shape[0]} rows")
        return QuantStore(
            codes=np.concatenate([self.codes[idx], np.zeros((pad, self.dim), np.int8)]),
            scales=self.scales.copy(), device=self.device,
        )

    def memory_bytes(self) -> int:
        # codes + scales + the derived device-resident sq-norm row
        return int(self.codes.nbytes + self.scales.nbytes + 4 * self.rows)

    def snapshot_state(self) -> tuple[dict, dict]:
        """(arrays, statics) as the JAX store gives them (sq-norms are
        derived, not persisted)."""
        return {"codes": self.codes, "scales": self.scales}, {}

    @classmethod
    def from_snapshot(cls, arrays: dict, statics: dict, *,
                      device: DeviceLike = None) -> "QuantStore":
        return cls(codes=np.asarray(arrays["codes"], np.int8),
                   scales=np.asarray(arrays["scales"], np.float32),
                   device=resolve_device(device))
