"""Gemma-2B [arXiv:2403.08295] — GeGLU, MQA, head_dim=256.

18L, d_model=2048, 8 heads (MQA kv=1), d_ff=16384 (GeGLU), vocab=256000,
tied embeddings, (1+w) RMSNorm, sqrt(d) embedding scale.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="gemma-2b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    gemma_norm=True,
    tie_embeddings=True,
)

REDUCED = LMConfig(
    name="gemma-2b-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    activation="geglu",
    gemma_norm=True,
    tie_embeddings=True,
    remat=False,
    dtype="float32",
)
