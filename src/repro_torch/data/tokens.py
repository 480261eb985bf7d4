"""Deterministic synthetic recsys batches — ``recsys_batch`` of
``repro/data/tokens.py``, copied.  Host-side numpy only, so the same
(seed, step) gives the same arrays in both packages.  The LM token stream
waits for the LM slice."""
from __future__ import annotations

import numpy as np


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
