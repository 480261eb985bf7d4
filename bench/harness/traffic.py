"""The one traffic generator: it reads a mix's parameters from its data file
(``bench/traffic/<mix>.json``) and draws everything from ``--seed``.

Keys of a mix:

* ``loop``: ``"closed"``: one client sends its next batch when the last one
  is answered;
* ``k``: neighbours asked for;
* ``batch``: queries per request, taken in a seeded order from the
  configuration's query set and cycled;
* ``delete_frozen``: rows of the frozen corpus deleted in set-up, drawn
  without replacement;
* ``reinsert_deleted``: after the deletes, the deleted rows' vectors are
  upserted again as new rows (a delete-and-re-insert cycle).

Each purpose draws from its own stream of the seed, so adding a key to a
mix does not move the others.
"""
from __future__ import annotations

import numpy as np

_ORDER, _DELETES = 1, 3


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def query_order(n_queries: int, seed: int) -> np.ndarray:
    """The closed loop's order of the query set: a permutation."""
    return _rng(seed, _ORDER).permutation(n_queries)


def closed_batch(order: np.ndarray, batch: int, i: int) -> np.ndarray:
    """Query ids of the i-th batch: the next ``batch`` of the cycled order."""
    n = order.shape[0]
    start = (i * batch) % n
    return np.take(order, np.arange(start, start + batch), mode="wrap")


def deleted_rows(traffic: dict, n_frozen: int, seed: int) -> np.ndarray:
    """Frozen rows the mix deletes in set-up (sorted), or none."""
    count = int(traffic.get("delete_frozen", 0))
    if count == 0:
        return np.zeros((0,), np.int64)
    return np.sort(_rng(seed, _DELETES).choice(n_frozen, size=count, replace=False))
