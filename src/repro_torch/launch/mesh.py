"""Mesh builders — port of ``repro/launch/mesh.py``.

The port's mesh holds every rank on one device (``dist/sharding.Mesh``):
``make_test_mesh`` is its counterpart of JAX's forced host devices.
``make_production_mesh`` keeps JAX's contract and raises without the 256
(one pod) or 512 (two pods) devices it names; a mesh across several cards
waits for a later slice.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) = 256 chips per pod; multi_pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = math.prod(shape)
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — "
            "run under launch/dryrun.py which forces 512 host devices"
        )
    raise NotImplementedError("a mesh across several cards is not ported yet")


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device: DeviceLike = None) -> Mesh:
    """Small mesh for tests and the smoke: every rank on ``device``
    (default CUDA)."""
    return Mesh(shape, axes, resolve_device(device))
