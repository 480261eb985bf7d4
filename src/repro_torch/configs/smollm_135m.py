"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L, d_model=576, 9 heads (GQA kv=3, head_dim=64), d_ff=1536, vocab=49152,
tied embeddings, SwiGLU, RMSNorm, rope theta 10000.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="smollm-135m",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)

REDUCED = LMConfig(
    name="smollm-135m-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=True,
    remat=False,
    dtype="float32",
)
