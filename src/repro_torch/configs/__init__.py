"""Architecture registry of the port: ``get`` / ``get_reduced`` / ``family``
for the recsys architectures, as ``repro/configs/__init__.py`` has them.

Each module defines CONFIG (the published dims) and REDUCED (same family,
tiny dims — the CPU test configs).  The LM, GNN and search entries wait for
their slices.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "deepfm": "repro_torch.configs.deepfm",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "fm": "repro_torch.configs.fm",
    "autoint": "repro_torch.configs.autoint",
}

FAMILY = {
    "deepfm": "recsys",
    "xdeepfm": "recsys",
    "fm": "recsys",
    "autoint": "recsys",
}


def get(arch: str):
    mod = importlib.import_module(ARCHS[arch])
    return mod.CONFIG


def get_reduced(arch: str):
    mod = importlib.import_module(ARCHS[arch])
    return mod.REDUCED


def family(arch: str) -> str:
    return FAMILY[arch]
