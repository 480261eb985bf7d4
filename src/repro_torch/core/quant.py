"""Symmetric absmax int8 quantisation — the part of ``repro.core.quant``
this slice needs: the definition (``absmax_scales`` / ``encode`` /
``decode``) and the rerank-width rule the beam widens its shortlist with
(``shortlist_width``).  ``QuantStore`` and the int8 scan come later.

``scale = max(|x|) / 127``; ``code = clip(round(x / scale), -127, 127)``
(``torch.round`` rounds half to even, as ``jnp.round`` does);
``decode = code * scale``.
"""
from __future__ import annotations

import torch

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


def shortlist_width(k: int, n: int, *, mult: int = 4, floor: int = 32) -> int:
    """How many first-stage candidates the exact rerank re-scores for a
    final top-k over n rows: ``min(n, pow2ceil(max(mult * k, floor)))``."""
    from repro_torch.core.scan import pow2ceil

    return min(int(n), pow2ceil(max(mult * int(k), floor)))
