"""Beam recall@10 on ``fashion_like`` as the corpus grows, for either package.

    PYTHONPATH=src python tests/torch_recall_ladder.py --package both \
        --config reduced --sizes 4000 8000 16000 32000
    PYTHONPATH=src python tests/torch_recall_ladder.py --package port \
        --device cuda --config default --sizes 4000 8000 16000 32000 60000
    PYTHONPATH=src python tests/torch_recall_ladder.py --package both \
        --metric manhattan --sizes 4000

For each corpus size n the same ``fashion_like(n + 256, seed=0)`` pool is
split into corpus and queries, an ``InfinityIndex`` is built at q=inf with
the chosen config and ``--metric`` (the original dissimilarity: the kNN
graph, D and the rerank use it), and one beam search (k=10, budget 1024,
rerank 256) is held against the exact top 10 in that metric (the port's
``topk_scan``).  ``--config
reduced`` is proj_sample 512 / 300 training steps; ``default`` is
``IndexConfig()``, the config ``chip_smoke.py`` builds at n=60000.

``--package jax`` or ``both`` imports the JAX package (CPU only); ``port``
needs only torch.  Each size prints one JSON line; ``--out`` also writes
them to a file.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch.core import scan as tscan
from repro_torch.core.search import IndexConfig, InfinityIndex
from repro_torch.data import synthetic

CONFIGS = {
    "reduced": dict(q=math.inf, proj_sample=512, train_steps=300),
    "default": dict(q=math.inf),
}
SEARCH = dict(k=10, budget=1024, rerank=256, mode="beam")
QUERIES, SEED = 256, 0


def recall(ids, truth) -> float:
    ids, truth = np.asarray(ids), np.asarray(truth)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


def build_port(X, Q, cfg, device):
    idx = InfinityIndex.build(X, IndexConfig(**cfg), device=device)
    res = idx.search(torch.as_tensor(Q, device=idx.X.device), **SEARCH)
    return res.idx.cpu().numpy(), idx.train_history["validation"]


def build_jax(X, Q, cfg):
    import jax.numpy as jnp

    from repro.core.search import IndexConfig as JaxConfig
    from repro.core.search import InfinityIndex as JaxIndex

    idx = JaxIndex.build(jnp.asarray(X), JaxConfig(**cfg))
    res = idx.search(jnp.asarray(Q), **SEARCH)
    return np.asarray(res.idx), idx.train_history["validation"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("port", "jax", "both"), default="both")
    ap.add_argument("--config", choices=tuple(CONFIGS), default="reduced")
    ap.add_argument("--sizes", type=int, nargs="+", default=[4000, 8000, 16000, 32000])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--metric", default="euclidean")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    packages = ("jax", "port") if args.package == "both" else (args.package,)
    cfg = dict(CONFIGS[args.config], metric=args.metric)
    rows = []
    for n in args.sizes:
        pool = synthetic.fashion_like(n + QUERIES, seed=SEED)
        X, Q = pool[:n], pool[n:]
        _, gt = tscan.topk_scan(torch.as_tensor(Q, device=args.device),
                                torch.as_tensor(X, device=args.device), k=10,
                                metric=args.metric)
        gt = gt.cpu().numpy()
        for package in packages:
            t0 = time.perf_counter()
            if package == "port":
                ids, val = build_port(X, Q, cfg, args.device)
            else:
                ids, val = build_jax(X, Q, cfg)
            row = {"package": package, "config": args.config,
                   "metric": args.metric, "n": n,
                   "queries": QUERIES, "device": args.device if package == "port" else "cpu",
                   "beam_recall@10": recall(ids, gt),
                   "nn_overlap10": float(val["nn_overlap10"]),
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
