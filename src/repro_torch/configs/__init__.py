"""Architecture registry of the port: ``--arch <id>`` resolves here, as in
``repro/configs/__init__.py``.

Each module defines CONFIG (exact public-literature dims) and REDUCED (same
family, tiny dims — the CPU test configs).
"""
from __future__ import annotations

import importlib

ARCHS = {
    # LM family
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    # GNN
    "gcn-cora": "repro_torch.configs.gcn_cora",
    # RecSys
    "deepfm": "repro_torch.configs.deepfm",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "fm": "repro_torch.configs.fm",
    "autoint": "repro_torch.configs.autoint",
    # the paper's own pipeline as a selectable config
    "infinity-search": "repro_torch.configs.infinity_search",
}

FAMILY = {
    "smollm-135m": "lm",
    "deepseek-coder-33b": "lm",
    "gemma-2b": "lm",
    "qwen3-moe-235b-a22b": "lm",
    "deepseek-v3-671b": "lm",
    "gcn-cora": "gnn",
    "deepfm": "recsys",
    "xdeepfm": "recsys",
    "fm": "recsys",
    "autoint": "recsys",
    "infinity-search": "search",
}


def get(arch: str):
    mod = importlib.import_module(ARCHS[arch])
    return mod.CONFIG


def get_reduced(arch: str):
    mod = importlib.import_module(ARCHS[arch])
    return mod.REDUCED


def family(arch: str) -> str:
    return FAMILY[arch]
