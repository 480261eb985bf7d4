"""Shared neural-net layers (pure functions over param dicts) — port of
``repro/models/layers.py``.

As in JAX: norms are computed in f32 and cast back to the input dtype;
rotary angles are taken in f32 and the rotation applied in the activation
dtype; weights are cast to the activation dtype at each call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             gemma_style: bool = False) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if gemma_style else scale.float()
    return (y * w).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(dt)


def rotary_embedding(positions: torch.Tensor, head_dim: int, *,
                     theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos) of shape positions.shape + (head_dim // 2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, head_dim//2).
    The rotation runs in x's dtype."""
    x1, x2 = x.chunk(2, dim=-1)
    s = sin[..., None, :].to(x.dtype)  # broadcast over heads
    c = cos[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def glu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, *, activation: str = "swiglu") -> torch.Tensor:
    """Gated-linear-unit MLP: act(x W_g) * (x W_u) W_d."""
    g = x @ w_gate.to(x.dtype)
    u = x @ w_up.to(x.dtype)
    if activation == "swiglu":
        h = F.silu(g) * u
    elif activation == "geglu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        raise ValueError(activation)
    return h @ w_down.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V) upcast to f32 inside."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
