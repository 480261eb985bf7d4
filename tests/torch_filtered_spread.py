"""Filtered infinity recall at ``benchmarks/bench_filtered.py``'s
configuration over several build seeds, for either package.

    PYTHONPATH=src python tests/torch_filtered_spread.py --package both \
        --seeds 0 1 2 3

The bench's corpus (manifold, n = 2048, 64 queries, ``score`` uniform from
``default_rng(0)``) and its infinity config (q = inf, 512 sampled rows, 200
training steps, budget 256, rerank 64) are built once per ``seed`` (the
config's seed: the subset, Phi's initialisation and its pair draws), and
each ``score <= s`` filter's recall@10 is read against the scan over the
passing rows (``benchmarks/common.py:recall_at_k``).  One line per
(package, seed).  It shows how far one build's recall moves with its seed,
which bounds what a comparison of two packages' single builds can say.
``--package jax`` or ``both`` imports the JAX package (CPU only); ``port``
runs on ``--device``.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np

SELECTIVITIES = (0.9, 0.5, 0.1, 0.01)
N, QUERIES, K = 2048, 64, 10


def recall_at_k(approx, truth) -> float:
    return float(np.mean([len(set(map(int, a[:K])) & set(map(int, t[:K]))) / K
                          for a, t in zip(approx, truth)]))


def run(package: str, seeds, device: str) -> list[dict]:
    from repro_torch.data import synthetic

    if package == "jax":
        from repro.core import index as index_lib
        kw = {}
    else:
        from repro_torch.core import index as index_lib
        kw = {"device": device}
    rng = np.random.default_rng(0)
    pool = synthetic.make("manifold", N + QUERIES, seed=0)
    corpus, queries = pool[:N], pool[N:]
    score = rng.uniform(0.0, 1.0, size=N).astype(np.float32)
    truth = {}
    for s in SELECTIVITIES:
        mask = score <= s
        rows = np.where(mask)[0]
        gt = np.asarray(index_lib.build("brute", corpus[mask], {}, **kw)
                        .search(queries, k=K).idx.tolist())
        truth[s] = np.where(gt >= 0, rows[np.maximum(gt, 0)], -1)
    out = []
    for seed in seeds:
        eng = index_lib.build("infinity", corpus, {
            "q": math.inf, "proj_sample": 512, "train_steps": 200, "rerank": 64,
            "budget": 256, "seed": seed, "attrs": {"score": score}}, **kw)
        rec = {str(s): recall_at_k(np.asarray(eng.search(
            queries, k=K, filter={"score": {"range": [None, s]}}).idx.tolist()), truth[s])
            for s in SELECTIVITIES}
        out.append({"package": package, "seed": seed, "recall@10": rec})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    for package in (("jax", "port") if args.package == "both" else (args.package,)):
        run(package, args.seeds, args.device)


if __name__ == "__main__":
    main()
