"""AutoInt [arXiv:1810.11921]: 3 self-attn layers, 2 heads, d_attn=32,
embed_dim=16, no deep branch (attention output direct to logit)."""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="autoint",
    interaction="self-attn",
    n_sparse=39,
    embed_dim=16,
    mlp=(),
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
)

REDUCED = RecsysConfig(
    name="autoint-reduced",
    interaction="self-attn",
    n_sparse=6,
    embed_dim=8,
    vocabs=(64, 32, 32, 16, 16, 8),
    mlp=(),
    n_attn_layers=2,
    n_heads=2,
    d_attn=8,
)
