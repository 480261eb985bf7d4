"""Gradient compression (port of ``repro/dist/compression.py``).

``fake_int8_roundtrip`` models int8 quantize -> transmit -> dequantize with
per-leaf absmax scaling: the values the wire would carry, without an int8
collective.  ``ErrorFeedback`` carries the quantization residual into the
next step, which keeps the accumulated transmitted gradient unbiased.

The quantizer is ``core/quant.fake_quant``, the port's one absmax int8
definition (the same scale formula, clipping and eps floor as the corpus
codes), as JAX's is ``repro.core.quant.fake_quant``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.quant import fake_quant as _quantize_leaf
from repro_torch.train import tree as tree_lib

Tree = Any


def fake_int8_roundtrip(grads: Tree) -> Tree:
    """Per-leaf absmax int8 quantize + dequantize (max error scale / 2)."""
    return tree_lib.tree_map(_quantize_leaf, grads)


class ErrorFeedback:
    """Residual-carrying compression: sent_t = Q(g_t + r_t); r_{t+1} = g_t +
    r_t - sent_t.  Stateless namespace (the residual tree is the state)."""

    @staticmethod
    def init(grads: Tree) -> Tree:
        return tree_lib.tree_map(torch.zeros_like, grads)

    @staticmethod
    def apply(grads: Tree, residual: Tree) -> tuple[Tree, Tree]:
        total = tree_lib.tree_map(lambda g, r: g + r, grads, residual)
        sent = tree_lib.tree_map(_quantize_leaf, total)
        new_resid = tree_lib.tree_map(lambda t, s: t - s, total, sent)
        return sent, new_resid
