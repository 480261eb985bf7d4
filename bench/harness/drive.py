"""The measured window: a closed loop of batches.  It returns what it
sent, what came back and the host clock's times; nothing here judges."""
from __future__ import annotations

import time

import numpy as np

from bench.harness import traffic as traffic_lib


class Answers:
    """Every answer of a window: the query ids asked, the ids and
    distances returned, the comparisons the program reported."""

    def __init__(self):
        self.qids, self.idx, self.dist, self.comps = [], [], [], []

    def add(self, qids, res) -> None:
        n = len(qids)
        self.qids.append(np.asarray(qids, np.int64))
        self.idx.append(np.asarray(res.idx)[:n])
        self.dist.append(np.asarray(res.dist)[:n])
        self.comps.append(np.asarray(res.comparisons)[:n])

    def extend(self, other: "Answers") -> None:
        for name in ("qids", "idx", "dist", "comps"):
            getattr(self, name).extend(getattr(other, name))

    def arrays(self, k: int):
        if not self.qids:
            return (np.zeros((0,), np.int64), np.zeros((0, k), np.int64),
                    np.zeros((0, k), np.float32), np.zeros((0,), np.int64))
        return (np.concatenate(self.qids), np.concatenate(self.idx).astype(np.int64),
                np.concatenate(self.dist), np.concatenate(self.comps).astype(np.int64))


def closed_window(server, queries_host: np.ndarray, order: np.ndarray, *,
                  batch: int, k: int, seconds: float, first: int = 0,
                  mark=None) -> dict:
    """One client: send batch after batch, each when the last is answered,
    until ``seconds`` have passed; the window closes when the batch in
    flight at that moment is answered.  ``first``: the index of the first
    batch in the cycled order.  ``mark``: a context manager factory put
    around each call (the trace's annotations)."""
    n = order.shape[0]
    ordered = queries_host[order]
    if batch > n:
        raise ValueError(f"batch {batch} is larger than the query set ({n})")
    ring = np.concatenate([ordered, ordered[:batch]])
    answers = Answers()
    walls, failed, i = [], 0, first
    t0 = time.perf_counter()
    end = t0
    while end - t0 < seconds:
        start = (i * batch) % n
        qids = traffic_lib.closed_batch(order, batch, i)
        rows = ring[start : start + batch]
        i += 1
        t_call = time.perf_counter()
        try:
            if mark is None:
                res = server.query(rows, k=k)
            else:
                with mark("bench.query"):
                    res = server.query(rows, k=k)
        except Exception as exc:  # counted as failed, the loop goes on
            failed += batch
            print(f"query failed: {exc!r}", flush=True)
        else:
            # rows the program left out of its answer never come back
            got = min(batch, len(res.idx))
            failed += batch - got
            answers.add(qids[:got], res)
        end = time.perf_counter()
        walls.append(end - t_call)
    return {"seconds": end - t0, "attempted": (i - first) * batch, "failed": failed,
            "missing": failed, "batches": i - first, "walls": walls,
            "answers": answers, "next": i}
