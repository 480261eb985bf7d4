"""xDeepFM [arXiv:1803.05170]: CIN 200-200-200 + 400-400 MLP, embed_dim=10."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="xdeepfm",
    interaction="cin",
    n_sparse=39,
    embed_dim=10,
    cin_layers=(200, 200, 200),
    mlp=(400, 400),
)

REDUCED = RecsysConfig(
    name="xdeepfm-reduced",
    interaction="cin",
    n_sparse=6,
    embed_dim=4,
    vocabs=(64, 32, 32, 16, 16, 8),
    cin_layers=(16, 16),
    mlp=(32,),
)
