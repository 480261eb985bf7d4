"""DeepSeek-Coder-33B [arXiv:2401.14196] — llama-arch.

62L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=19200,
vocab=32256, SwiGLU, rope.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
)

REDUCED = LMConfig(
    name="deepseek-coder-33b-reduced",
    num_layers=2,
    d_model=96,
    num_heads=6,  # not divisible by small test meshes either — exercises SP
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    remat=False,
    dtype="float32",
)
