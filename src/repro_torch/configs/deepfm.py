"""DeepFM [arXiv:1703.04247]: FM branch + 400-400-400 MLP, embed_dim=10."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="deepfm",
    interaction="fm",
    n_sparse=39,
    embed_dim=10,
    mlp=(400, 400, 400),
)

REDUCED = RecsysConfig(
    name="deepfm-reduced",
    interaction="fm",
    n_sparse=6,
    embed_dim=4,
    vocabs=(64, 32, 32, 16, 16, 8),
    mlp=(32, 32),
)
