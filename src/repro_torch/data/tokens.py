"""Deterministic synthetic data — ``TokenStream`` and ``recsys_batch`` of
``repro/data/tokens.py``, copied.  Host-side numpy only, so the same
(seed, step) gives the same arrays in both packages.

The token stream is sharded by (host_id, num_hosts): every host
materialises only its slice of the global batch.  Sequences are drawn from
a Zipfian unigram model with Markov bigram structure.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    def __post_init__(self):
        assert self.global_batch % self.num_hosts == 0
        rng = np.random.default_rng(self.seed)
        # Zipf unigram + low-rank bigram mixing matrix
        ranks = np.arange(1, self.vocab_size + 1)
        self.unigram = (1.0 / ranks**1.1)
        self.unigram /= self.unigram.sum()
        self.shift = rng.integers(1, self.vocab_size, size=64)

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch(self, step: int) -> dict:
        """{"tokens" (local_batch, seq_len) int32} for ``step``."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4099 + self.host_id
        )
        b = self.local_batch
        base = rng.choice(
            self.vocab_size, size=(b, self.seq_len), p=self.unigram
        ).astype(np.int32)
        # Markov-ish structure: half the positions continue the previous
        # token through a fixed permutation-shift
        cont = rng.random((b, self.seq_len)) < 0.5
        shifted = (np.roll(base, 1, axis=1) + self.shift[step % 64]) % self.vocab_size
        tokens = np.where(cont, shifted, base).astype(np.int32)
        return {"tokens": tokens}


def recsys_batch(step: int, batch: int, vocabs, *, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1) -> dict:
    """{"ids" (batch // num_hosts, len(vocabs)) int32, uniform per field;
    "labels" (batch // num_hosts,) f32}, reproducible from (seed, step)."""
    rng = np.random.default_rng((seed * 999_983 + step) * 4099 + host_id)
    b = batch // num_hosts
    ids = np.stack(
        [rng.integers(0, v, size=b) for v in vocabs], axis=1
    ).astype(np.int32)
    # labels correlated with a random linear score of the ids (learnable)
    w = np.random.default_rng(seed).normal(size=len(vocabs))
    score = (ids % 97) @ w / (97 * np.sqrt(len(vocabs)))
    labels = (score + 0.25 * rng.normal(size=b) > 0).astype(np.float32)
    return {"ids": ids, "labels": labels}
