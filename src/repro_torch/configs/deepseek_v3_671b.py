"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA + fine-grained MoE + MTP.

61L (3 dense + 58 MoE), d_model=7168, 128 heads MLA (q_lora=1536,
kv_lora=512, nope=128, rope=64, v=128), MoE 256 routed experts top-8 +
1 shared, moe_d_ff=2048, dense d_ff=18432, vocab=129280, sigmoid router
with top-k renorm + routed scaling 2.5, MTP (1 module).
"""
from repro_torch.configs.base import LMConfig, MLAConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-head latent KV; field kept for the record
    head_dim=128,
    d_ff=18432,         # the 3 leading dense layers
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    moe=True,
    num_experts=256,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    first_dense_layers=3,
    router="sigmoid",
    mtp=True,
)

REDUCED = LMConfig(
    name="deepseek-v3-reduced",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    ),
    moe=True,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=32,
    num_shared_experts=1,
    first_dense_layers=1,
    router="sigmoid",
    mtp=True,
    remat=False,
    dtype="float32",
)
