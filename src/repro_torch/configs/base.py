"""Configuration dataclasses and shapes of the port — ``repro/configs/
base.py``, copied (this package imports nothing of ``repro``): the LM
transformers, the GNN and the recsys models, each with its family's shape
set.  Dtypes are names, not framework types; ``LMConfig.act_dtype()`` /
``pdtype()`` map them to torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavor
    attention: str = "gqa"  # gqa | mla
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10000.0
    # mlp flavor
    activation: str = "swiglu"  # swiglu | geglu
    # moe
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0  # leading dense layers (deepseek-v3: 3)
    router: str = "softmax"  # softmax | sigmoid (ds-v3 aux-free style)
    capacity_factor: float = 1.25
    # extras
    norm_eps: float = 1e-6
    gemma_norm: bool = False  # (1 + w) RMSNorm scaling + embed * sqrt(d)
    tie_embeddings: bool = False
    mtp: bool = False  # deepseek-v3 multi-token-prediction head (1 module)
    # numerics
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"
    remat: bool = True

    @property
    def num_moe_layers(self) -> int:
        return (self.num_layers - self.first_dense_layers) if self.moe else 0

    @property
    def num_dense_layers(self) -> int:
        return self.first_dense_layers if self.moe else self.num_layers

    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = (
    LMShape("train_4k", seq_len=4096, global_batch=256, kind="train"),
    LMShape("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    LMShape("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    LMShape("long_500k", seq_len=524288, global_batch=1, kind="decode"),
)


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    num_layers: int = 2
    d_hidden: int = 16
    num_classes: int = 7
    aggregator: str = "mean"
    norm: str = "sym"  # symmetric degree normalization (GCN)
    dropout: float = 0.5
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str  # full | sampled | batched
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    n_graphs: int = 0  # batched-small-graphs


GNN_SHAPES = (
    GNNShape("full_graph_sm", kind="full", n_nodes=2708, n_edges=10556, d_feat=1433),
    GNNShape(
        "minibatch_lg", kind="sampled", n_nodes=232965, n_edges=114615892,
        d_feat=602, batch_nodes=1024, fanout=(15, 10),
    ),
    GNNShape("ogb_products", kind="full", n_nodes=2449029, n_edges=61859140, d_feat=100),
    GNNShape("molecule", kind="batched", n_nodes=30, n_edges=64, d_feat=16, n_graphs=128),
)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

# Criteo-flavoured vocabulary sizes for 39 sparse fields: a few huge ID
# spaces, a tail of small categorical fields.  They sum to 30 226 200 rows
# (30 226 432 once padded to a multiple of 2048 by
# ``models/recsys._padded_vocab``).
RECSYS_VOCABS = tuple(
    [10_000_000, 8_000_000, 5_000_000, 3_000_000, 2_000_000, 1_000_000]
    + [500_000, 300_000, 200_000, 100_000, 50_000, 20_000, 10_000]
    + [5000] * 6 + [2000] * 6 + [500] * 7 + [100] * 7
)
assert len(RECSYS_VOCABS) == 39


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str  # fm | fm2 | cin | self-attn
    n_sparse: int = 39
    embed_dim: int = 10
    vocabs: tuple[int, ...] = RECSYS_VOCABS
    mlp: tuple[int, ...] = (400, 400, 400)
    # xDeepFM CIN
    cin_layers: tuple[int, ...] = ()
    # AutoInt
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return sum(self.vocabs[: self.n_sparse])


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str  # train | serve | retrieval
    batch: int
    n_candidates: int = 0


RECSYS_SHAPES = (
    RecsysShape("train_batch", kind="train", batch=65536),
    RecsysShape("serve_p99", kind="serve", batch=512),
    RecsysShape("serve_bulk", kind="serve", batch=262144),
    RecsysShape("retrieval_cand", kind="retrieval", batch=1, n_candidates=1_000_000),
)
