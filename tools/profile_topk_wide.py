#!/usr/bin/env python3
"""Where the f32 topk kernel's time goes above k = 512, on one CUDA card.

    python3 tools/profile_topk_wide.py [--seed 0] [--rows NAME ...] [--root DIR]

Run from the root of the repo.  At ``chip_smoke.py``'s shapes (the
``fashion_like`` 60000 x 784 corpus, one 512-query serve batch) it reports,
as one JSON line per row of ``ROWS``, by ``chip_smoke.py``'s method:

- ``ms``: ``topk_cuda`` by CUDA events, the mean of back-to-back calls
  after a warm-up; ``bound_ms`` and ``share``, its least time
  (``dist/roofline.topk_work``) over ``ms``; ``plain_ms`` (``topk_ref``) and
  ``library_ms`` (``torch.cdist`` + ``torch.topk``);
- ``kernels_ms``: each kernel's device time a call under ``torch.profiler``
  (``sqnorm_kernel``, ``topk_kernel``, ``merge_kernel``: above k = 512
  the last is the select);
- ``max_abs_err`` and ``ids_identical`` against the plain version
  (``chip_smoke.close_matmul`` / ``ids_agree``: it fails on a
  disagreement), and the plan (``chunk_rows``, ``splits``).

The rows at k <= 512 (the brute batch, the live delta) run the kernel's
list instances, as controls.  ``--root`` runs another checkout's package and
``chip_smoke.py`` (e.g. an unpacked parent commit) with this file's rows,
so two versions compare in one call.  The line before the last is the
card's name and power limit as ``nvidia-smi`` gives them; the last is one
JSON object of every row and the instances' registers and spills.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: name -> (queries, corpus rows, k, metric, masked): the live cell's frozen
#: oversample at k' = 4096 and the 1 % mix's 1024, the k = 600 batch rows,
#: one of two live shards, and the k <= 512 controls (brute batch, live
#: delta of 4096 slots, every slot alive)
ROWS = {
    "live frozen oversample k=4096": (512, 60000, 4096, "euclidean", False),
    "live frozen oversample k=1024": (512, 60000, 1024, "euclidean", False),
    "wide k: brute batch k=600": (512, 60000, 600, "euclidean", False),
    "wide k: brute batch k=600 manhattan": (512, 60000, 600, "manhattan", False),
    "live shard k=1024": (512, 30000, 1024, "euclidean", False),
    "brute batch k=10": (512, 60000, 10, "euclidean", False),
    "live delta k=10": (512, 4096, 10, "euclidean", True),
}
KERNELS = ("sqnorm_kernel", "topk_kernel", "merge_kernel")
DEVICE = "cuda"


def kernel_ms(fn, calls: int = 3) -> dict:
    """Device milliseconds a call of each of ``KERNELS``, from
    ``torch.profiler`` over ``calls`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in KERNELS}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        for name in KERNELS:
            if name in e.key and "topk_int8" not in e.key:
                out[name] += us / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", nargs="*", default=list(ROWS), choices=list(ROWS))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "src"))

    import torch

    from chip_smoke import (_bound, _ptxas_summary, close_matmul, cuda_ms, fail,
                            ids_agree)
    from repro_torch.data import synthetic
    from repro_torch.dist import roofline
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk import topk as topk_mod
    from repro_torch.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas = _ptxas_summary(_build.build()["ptxas"])
    dev = torch.device(DEVICE)
    pool = torch.as_tensor(synthetic.fashion_like(60000 + 512, seed=args.seed), device=dev)
    corpus, q = pool[:60000], pool[60000:]
    out = []
    for name in args.rows:
        m, n, k, metric, masked = ROWS[name]
        Y = corpus[:n]
        valid = torch.ones(n, dtype=torch.bool, device=dev) if masked else None
        cube = metric != "euclidean"

        def call():
            return topk_cuda(q, Y, k=k, metric=metric, valid=valid)

        od, oi = call()
        rd, ri = topk_ref(q, Y, k=k + 1, metric=metric, valid=valid)
        err, ok = close_matmul(od, rd[:, :k])
        same, ids_ok = ids_agree(oi, ri, rd, k)
        if not (ok and ids_ok):
            fail(f"{name}: topk disagrees with its plain version (max err {err}, "
                 f"identical ids {same})")
        del rd, ri
        slots = topk_mod._slots(metric, k, dev)
        wide = getattr(topk_mod, "wide_select", lambda k: False)(k)
        chunk, plan = (topk_mod.wide_plan(m, n, slots) if wide
                       else (m, topk_mod.split_plan(m, n, k, slots)))
        p = 1.0 if metric == "manhattan" else 2.0
        # the lists' path took ~1 s a call at k = 4096
        reps = 20 if wide or k <= 1024 else 2
        row = {
            "name": name, "shape": [m, n, 784], "k": k, "metric": metric,
            "masked": masked, "chunk_rows": chunk, "splits": len(plan),
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(call, reps),
            "kernels_ms": kernel_ms(call, 3 if reps > 2 else 1),
            "plain_ms": cuda_ms(lambda: topk_ref(q, Y, k=k, metric=metric, valid=valid),
                                2 if cube else 5),
            "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(q, Y, p=p), k, dim=1,
                                                     largest=False), 2 if cube else 10),
            "bound": _bound(*roofline.topk_work(m, n, 784, k, cube=cube, masked=masked)),
        }
        row["share"] = row["bound"]["ms"] / row["ms"]
        print(json.dumps(row), flush=True)
        out.append(row)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": root, "rows": out,
                      "instances": {k: v for k, v in ptxas.items()
                                    if k.startswith(("topk_kernel", "merge_kernel",
                                                     "sqnorm_kernel"))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
