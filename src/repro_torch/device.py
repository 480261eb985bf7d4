"""Device policy of the port.

Entry points take ``device=`` and default to ``"cuda"``.  Without a CUDA
device they raise unless the caller asked for the CPU explicitly: the port
never falls back to the CPU silently.  Functions that take tensors run on
the device their inputs live on.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when it
    names CUDA and no CUDA device is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU"
        )
    return dev


def sync(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU) — for host
    clocks around device work."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
