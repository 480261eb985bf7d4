"""Recsys configuration dataclasses and shapes — the recsys part of
``repro/configs/base.py``, copied (this package imports nothing of
``repro``).  The LM and GNN parts wait for their slices.  Dtypes are
names, not framework types."""
from __future__ import annotations

import dataclasses

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
