#!/usr/bin/env python3
"""The beam's level-loop kernel (``csrc/beam.cu``) at the b512 cells' shapes,
on one CUDA card.

    python3 tools/profile_beam.py [--seed 0] [--reps 50]

Run from the root of the repo.  Over a VP tree of 60 000 seeded rows of
d = 32 (the cells' Phi width; leaf size 16) and 512 queries near them, at
the cells' plan (budget 1 024: W 16, Bcap 32) and K 256 (the rerank's
width), for q = inf and q = 2, it prints one JSON line a row:

- ``ms``: ``beam_cuda`` by CUDA events, the mean of ``--reps`` back-to-back
  calls after a warm-up; ``plain_ms``: the plain loop
  (``core/vptree.beam_levels``) on the card, the same way;
- ``bound``: the least time for the bytes the batch's levels read, each
  query's reads counted (a scored vantage: its row and 24 bytes of node
  arrays; a ranked bucket: its centroid row), the queries and the outputs,
  at the HBM rate; ``share`` = bound / ms;
- ``vantages`` and ``centroids`` a query (the plain version's counters),
  how far the kernel's best list is from the plain version's, and whether
  its distances are bit-equal (``bit_equal``; the tests hold them to the
  f32 tolerance only); it fails if ``buf`` or the counters differ.

The line before the last is the card's name and power limit as
``nvidia-smi`` gives them; the last is one JSON object of every row and the
kernel's registers, shared memory and spills.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys

N, D, B, LEAF, K, BUDGET = 60000, 32, 512, 16, 256, 1024


def _ptxas(report: str) -> dict:
    """``-Xptxas -v``'s lines for the beam kernel."""
    out, inside = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            inside = "beam_kernel" in line
        elif inside and re.search(r"Used \d+ registers|spill", line):
            out.append(line.split("ptxas info    :")[-1].strip())
    return {"beam_kernel": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))

    import numpy as np
    import torch

    from chip_smoke import _bound, cuda_ms, fail
    from repro_torch.core import vptree
    from repro_torch.kernels import _build
    from repro_torch.kernels.beam.beam import beam_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    Q = X[rng.choice(N, B, replace=False)] + 0.1 * rng.normal(size=(B, D))
    tree = vptree.build_vptree(X, seed=args.seed, device="cpu")
    flat = vptree.flatten_vptree(tree, leaf_size=LEAF, Z=X)
    Xf = torch.as_tensor(X[flat.perm.numpy()], device=dev)
    flat = flat._replace(**{f: getattr(flat, f).to(dev) for f in flat._fields
                            if isinstance(getattr(flat, f), torch.Tensor)})
    Q = torch.as_tensor(Q.astype(np.float32), device=dev)
    W, Bcap = vptree.beam_plan(BUDGET, depth=flat.depth, leaf_size=LEAF,
                               num_nodes=flat.num_nodes, num_buckets=flat.num_buckets, k=K)
    out = []
    for q in (math.inf, 2.0):
        kw = dict(q=q, k=K, beam_width=W, bucket_cap=Bcap, X=Xf)
        row = {"name": f"beam levels q={q}", "shape": [B, N, D], "W": W, "Bcap": Bcap,
               "K": K, "depth": flat.depth}
        want = vptree.beam_levels(flat, Q, **kw)
        got = beam_cuda(flat, Q, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got[2:], want[2:])):
            fail(f"{row['name']}: the kernel's buf or counters differ from the plain version")
        c_trav, c_cent = (float(c.sum()) for c in want[3:])
        nbytes = (c_trav * (D * 4 + 24) + c_cent * D * 4 + B * D * 4
                  + B * (K * 12 + Bcap * 8 + 16))
        row.update({
            "vantages": c_trav / B, "centroids": c_cent / B,
            "best_i_equal_share": float((got[1] == want[1]).float().mean()),
            "best_d_max_abs_err": float((got[0] - want[0]).abs().nan_to_num(0.0).max()),
            "bit_equal": bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
            "ms": cuda_ms(lambda: beam_cuda(flat, Q, **kw), args.reps),
            "plain_ms": cuda_ms(lambda: vptree.beam_levels(flat, Q, **kw), 5),
            "bound": _bound(0.0, "f32", nbytes),
        })
        row["share"] = row["bound"]["ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        out.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"rows": out, "instances": _ptxas(_build.build()["ptxas"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
