"""Recall@10 of the IVF and NSW engines on ``fashion_like``, built by each
package from the same corpus.

    PYTHONPATH=src python tests/torch_engine_recall.py --package both --n 8000
    PYTHONPATH=src python tests/torch_engine_recall.py --package port \
        --device cuda --n 60000 --lists 256

``fashion_like(n + 500, seed=0)`` is split into corpus and queries;
``ivf_flat`` (``--lists`` lists, nprobe 8), ``ivf_pq`` (the same lists, M 16,
256 centroids a subspace, rerank 64) and ``nsw`` (degree 16, 4 long links,
ef 48, 128 steps) are built through each package's registry (``chip_smoke.py``
phase 8's configs, with ``--lists`` in place of 256) and held against the
exact top 10.  The packages draw k-means' initial centroids from different
generators, so their IVF recall agrees in distribution, not exactly.  One
JSON line per (package, engine).  ``--package jax`` or ``both`` imports the
JAX package (CPU only).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

QUERIES, K = 500, 10


def configs(lists: int) -> dict:
    return {"ivf_flat": {"num_clusters": lists, "nprobe": 8},
            "ivf_pq": {"num_clusters": lists, "M": 16, "ksub": 256, "nprobe": 8,
                       "rerank": 64},
            "nsw": {"ef": 48, "max_steps": 128}}


def run(package: str, n: int, lists: int, device: str) -> list[dict]:
    from repro_torch.data import synthetic

    if package == "jax":
        from repro.core import index as index_lib
        kw = {}
    else:
        from repro_torch.core import index as index_lib
        kw = {"device": device}
    pool = synthetic.fashion_like(n + QUERIES, seed=0)
    corpus, queries = pool[:n], pool[n:]
    gt = np.asarray(index_lib.build("brute", corpus, {}, **kw).search(queries, k=K)
                    .idx.tolist())
    out = []
    for engine, cfg in configs(lists).items():
        t0 = time.perf_counter()
        eng = index_lib.build(engine, corpus, cfg, **kw)
        build_s = time.perf_counter() - t0
        res = eng.search(queries, k=K)
        ids = np.asarray(res.idx.tolist())
        rec = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, gt)]))
        out.append({"package": package, "engine": engine, "n": n, "config": cfg,
                    "recall@10": rec, "build_seconds": build_s,
                    "mean_comparisons": float(np.mean(np.asarray(res.comparisons.tolist())))})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--lists", type=int, default=90)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    for package in (("jax", "port") if args.package == "both" else (args.package,)):
        run(package, args.n, args.lists, args.device)


if __name__ == "__main__":
    main()
