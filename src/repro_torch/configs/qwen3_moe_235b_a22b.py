"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B family].

94L, d_model=4096, 64 heads (GQA kv=4, head_dim=128), MoE 128 experts top-8,
moe_d_ff=1536, vocab=151936, qk-norm, SwiGLU, softmax router.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,          # unused (all layers MoE); kept for reference
    vocab_size=151936,
    qk_norm=True,
    moe=True,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    router="softmax",
)

REDUCED = LMConfig(
    name="qwen3-moe-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    moe=True,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=64,
    router="softmax",
    remat=False,
    dtype="float32",
)
