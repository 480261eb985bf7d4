"""Factorization Machine [Rendle ICDM'10]: pure 2-way FM via the O(nk)
sum-square trick, embed_dim=10, no deep branch."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="fm",
    interaction="fm2",
    n_sparse=39,
    embed_dim=10,
    mlp=(),
)

REDUCED = RecsysConfig(
    name="fm-reduced",
    interaction="fm2",
    n_sparse=6,
    embed_dim=4,
    vocabs=(64, 32, 32, 16, 16, 8),
    mlp=(),
)
