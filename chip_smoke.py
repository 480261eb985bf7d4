#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit (as ``nvidia-smi`` reports
   them), torch and CUDA versions, the nvcc build of ``src/repro_torch/
   csrc`` and each kernel's registers and shared memory (``-Xptxas -v``).
2. Every kernel against its plain PyTorch version at the main path's
   shapes: pdist 2048x2048x784; topk for the kNN graph (2048x2048x784,
   k=16, self excluded) and the ground truth (10000x60000x784, k=10);
   qpath 2048^3 in all three modes.  Each prints its error, id agreement,
   the kernel's time (CUDA events after warm-up), the plain version's time
   and, where one PyTorch call computes the same function, that call's.
3. The main path at full width: an ``InfinityIndex`` with ``IndexConfig()``
   defaults over 60000 x 784 ``fashion_like`` vectors (the shape of
   Fashion-MNIST), 10000 queries served in batches of 512 (beam), one batch
   of 32 (best-first) and one k=1 search (descent).  The launch counters
   are zeroed just before and read just after each of three windows: the
   build must launch topk (kNN graph), pdist and six minmax sweeps; the
   ground-truth scan, topk; the serving window is reported.  Beam recall@10
   must reach ``FULL_RECALL_FLOOR`` and best-first ``BEST_FIRST_FLOOR``.
4. Recall parity with the committed JAX figures at the ``bench_infinity``
   config (manifold, n=2048, 512 queries): beam recall@10 within 0.03 of
   0.999 at q=2 and 0.939 at q=inf.  Each build is a counted window: six
   logminplus sweeps at q=2, six minmax sweeps at q=inf.

The line before the last is a JSON object listing every kernel, each with
the launches of the window that runs it (``path``); the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): f32 on the CUDA cores, HBM bandwidth.
F32_FLOPS = 67e12  # an FMA counts as two flops
F32_INSTR = F32_FLOPS / 2  # f32 lane instructions per second
# special-function units: 16 per SM per clock, 132 SMs at 1.98 GHz
SFU_OPS = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12

DEVICE = "cuda"
# main-path shapes: the projection subset (IndexConfig().proj_sample), the
# Fashion-MNIST corpus and query set, the serving batch
SUBSET, CORPUS, QUERIES, BATCH = 2048, 60000, 10000, 512

MATMUL_RTOL, MATMUL_ATOL = 1e-5, 5e-4  # tests/test_kernels.py:50 tolerance
LOGMINPLUS_ATOL = 1e-5
BENCH_TARGETS = {2.0: 0.999, math.inf: 0.939}  # experiments/BENCH_infinity.json
RECALL_SLACK = 0.03
# Full width: beam recall@10 read 0.0654 and best-first 0.084 on an H100
# with this data (fashion_like falls ~2x per doubling of n at budget 1024 in both
# packages: tests/torch_recall_ladder.py).  The floors sit well above what
# a search that returned unrelated rows would score (~256 / 60000).
FULL_RECALL_FLOOR = 0.045
BEST_FIRST_FLOOR = 0.03
NUM_HOPS = 6  # IndexConfig().num_hops: qpath sweeps per build
# the window whose launch count each qpath mode reports: q=inf builds sweep
# in minmax, finite-q builds in logminplus; no build sweeps in minplus
QPATH_PATHS = {"minmax": "full-width build", "minplus": None,
               "logminplus": "bench-config build q=2"}


def log(msg: str) -> None:
    print(msg, flush=True)


def counted(fn):
    """Run ``fn`` as one launch-counting window: the counters are zeroed
    just before and read just after (the card synchronised).  Returns
    (result, counts)."""
    import torch

    from repro_torch.kernels import _build

    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _build.launches()


def require(counts: dict, want: dict, what: str) -> None:
    """Each ``want`` entry is an exact count, or (lo,) for at least lo."""
    for name, n in want.items():
        ok = counts[name] >= n[0] if isinstance(n, tuple) else counts[name] == n
        if not ok:
            fail(f"{what}: launch counts {counts}, want {name} "
                 + (f">= {n[0]}" if isinstance(n, tuple) else f"== {n}"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls after
    one warm-up call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close_matmul(out, ref):
    """max |out - ref| and whether every entry is within the matmul-family
    tolerance (rtol 1e-5, atol 5e-4); infinities must coincide."""
    import torch

    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(out)):
        return float("inf"), False
    err = (out[fin] - ref[fin]).abs()
    ok = bool((err <= MATMUL_ATOL + MATMUL_RTOL * ref[fin].abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


def ids_agree(ids, ref_ids, ref_d, k: int):
    """Kernel ids against the plain version's (computed with k+1 columns):
    every mismatch must sit on a near tie, i.e. the plain distance at that
    position is within tolerance of a neighbouring rank's distance.
    Returns (share of identical ids, ok)."""
    import torch

    ids = ids.long()
    ref = ref_ids[:, :k].long()
    same = ids == ref
    d = ref_d
    tol = MATMUL_ATOL + MATMUL_RTOL * d.abs()
    nxt = (d[:, 1:] - d[:, :-1]).abs() <= tol[:, :-1]  # rank p ~ rank p+1
    near = torch.zeros_like(same)
    near[:, :k] |= nxt[:, :k]
    near[:, 1:k] |= nxt[:, :k - 1]
    ok = bool((same | near[:, :k]).all())
    return float(same.float().mean()), ok


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def _ptxas_summary(report: str) -> dict:
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            for short in ("pdist_kernel", "topk_kernel", "qpath_kernel"):
                if short in name:
                    mode = re.search(r"ILi(\d)E", name)
                    name = short + (f"<{mode.group(1)}>" if mode else "")
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?(.*)", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = {"registers": int(m.group(1)),
                         "smem_bytes": int(smem.group(1)) if smem else 0}
            name = None
    return out


def phase_environment(build_info: dict) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    env = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_seconds": build_info["seconds"],
        "kernels": _ptxas_summary(build_info["ptxas"]),
    }
    log(smi)
    log("env " + json.dumps(env))
    return env


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(seed: int) -> list[dict]:
    import torch

    from repro_torch.core import knn_graph as knn_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels.pdist.pdist import pdist_cuda
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.qpath.qpath import qpath_matmul_cuda
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref
    from repro_torch.kernels.topk.ref import topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda

    dev = torch.device(DEVICE)
    rows = []

    # pdist: D on the projection subset.  Compared as the build uses it,
    # with the diagonal set to 0: a self-distance is sqrt of f32 rounding
    # noise in |x|^2 + |x|^2 - 2 x.x (~1e-2 at these norms) in both
    # versions; its error is reported apart.
    S = torch.as_tensor(synthetic.fashion_like(SUBSET, seed=seed), device=dev)
    m = n = S.shape[0]
    d = S.shape[1]
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    out = pdist_cuda(S, S, metric="euclidean")
    ref = pdist_ref(S, S, metric="euclidean")
    diag_err = float((out.diagonal() - ref.diagonal()).abs().max())
    err, ok = close_matmul(torch.where(eye, 0.0, out), torch.where(eye, 0.0, ref))
    if not ok:
        fail(f"pdist disagrees with its plain version (max err {err})")
    rows.append({
        "name": "pdist", "case": f"D on S {m}x{n}x{d} euclidean",
        "path": "full-width build", "counter": "pdist",
        "source": "src/repro_torch/csrc/pdist.cu",
        "replaces": "src/repro/kernels/pdist/pdist.py:36",
        "max_abs_err": err, "diagonal_abs_err": diag_err,
        "ms": cuda_ms(lambda: pdist_cuda(S, S, metric="euclidean"), 20),
        "plain_ms": cuda_ms(lambda: pdist_ref(S, S, metric="euclidean"), 20),
        "library_ms": cuda_ms(lambda: torch.cdist(S, S), 20),
        "bound": _bound(ops=2 * m * n * d, rate=F32_FLOPS,
                        nbytes=4 * (m * d + n * d + m * n)),
    })
    log("kernel " + json.dumps(rows[-1]))

    # topk: the kNN graph of S, then the ground truth of the full corpus
    pool = torch.as_tensor(synthetic.fashion_like(CORPUS + QUERIES, seed=seed),
                           device=dev)
    corpus, queries = pool[:CORPUS], pool[CORPUS:]
    for case, path, Xq, Y, k, excl in (
        ("kNN graph", "full-width build", S, S, 16, True),
        ("ground truth", "full-width ground truth", queries, corpus, 10, False),
    ):
        m, n, d = Xq.shape[0], Y.shape[0], Xq.shape[1]
        od, oi = topk_cuda(Xq, Y, k=k, metric="euclidean", exclude_self=excl)
        rd, ri = topk_ref(Xq, Y, k=k + 1, metric="euclidean", exclude_self=excl)
        err, ok = close_matmul(od, rd[:, :k])
        same, ids_ok = ids_agree(oi, ri, rd, k)
        if not (ok and ids_ok):
            fail(f"topk ({case}) disagrees with its plain version "
                 f"(max err {err}, identical ids {same})")
        reps = 10 if m <= 4096 else 3
        rows.append({
            "name": "topk", "case": f"{case} {m}x{n}x{d} k={k}"
                                    + (" exclude_self" if excl else ""),
            "path": path, "counter": "topk",
            "source": "src/repro_torch/csrc/topk.cu",
            "replaces": "src/repro/kernels/topk/topk.py:123",
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_cuda(Xq, Y, k=k, metric="euclidean",
                                            exclude_self=excl), reps),
            "plain_ms": cuda_ms(lambda: topk_ref(Xq, Y, k=k, metric="euclidean",
                                                 exclude_self=excl), reps),
            "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(Xq, Y), k, dim=1,
                                                     largest=False), reps),
            "bound": _bound(ops=2 * m * n * d, rate=F32_FLOPS,
                            nbytes=4 * (m * d + n * d) + 8 * m * k),
        })
        log("kernel " + json.dumps(rows[-1]))
    del pool, corpus, queries

    # qpath: the first sweep's operands of the projection (E = D on the
    # symmetrised kNN graph + diagonal, +inf elsewhere)
    idx, _ = knn_lib.knn_graph(S, k=16, metric="euclidean")
    mask = knn_lib.knn_mask(idx, S.shape[0])
    D = torch.where(eye, 0.0, ref)
    E = torch.where(mask | mask.T | eye, D, float("inf"))
    ns = E.shape[0]
    for mode in ("minmax", "minplus", "logminplus"):
        A = 2.0 * torch.log(E) if mode == "logminplus" else E
        out = qpath_matmul_cuda(A, A, mode=mode)
        ref_q = qpath_matmul_ref(A, A, mode=mode)
        fin = torch.isfinite(ref_q)
        same_inf = torch.equal(fin, torch.isfinite(out)) and torch.equal(
            out[~fin], ref_q[~fin])
        err = float((out[fin] - ref_q[fin]).abs().max())
        ok = same_inf and (torch.equal(out, ref_q) if mode != "logminplus"
                           else err <= LOGMINPLUS_ATOL)
        if not ok:
            fail(f"qpath {mode} disagrees with its plain version (max err {err})")
        if mode == "logminplus":
            bound = _bound(ops=2 * ns ** 3, rate=SFU_OPS, nbytes=12 * ns * ns)
        else:
            bound = _bound(ops=2 * ns ** 3, rate=F32_INSTR, nbytes=12 * ns * ns)
        rows.append({
            "name": "qpath", "case": f"{mode} {ns}^3",
            "path": QPATH_PATHS[mode], "counter": f"qpath/{mode}",
            "source": "src/repro_torch/csrc/qpath.cu",
            "replaces": "src/repro/kernels/qpath/qpath.py:45",
            "max_abs_err": err,
            "ms": cuda_ms(lambda: qpath_matmul_cuda(A, A, mode=mode), 5),
            "plain_ms": cuda_ms(lambda: qpath_matmul_ref(A, A, mode=mode), 2),
            "library_ms": None,
            "bound": bound,
        })
        log("kernel " + json.dumps(rows[-1]))
    return rows


def _bound(*, ops: float, rate: float, nbytes: float) -> dict:
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES * 1e3
    return {"ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def _recall(approx, truth, k: int) -> float:
    a = approx[:, :k].cpu().numpy()
    t = truth[:, :k].cpu().numpy()
    return float(sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, t))
                 / (k * len(a)))


def _check_result(res, B: int, k: int, n: int, what: str) -> None:
    import torch

    idx, dist, comps = res
    if tuple(idx.shape) != (B, k) or tuple(dist.shape) != (B, k):
        fail(f"{what}: shapes {tuple(idx.shape)} / {tuple(dist.shape)}, want ({B}, {k})")
    if not bool(((idx >= 0) & (idx < n)).all()):
        fail(f"{what}: ids out of range")
    if not bool(torch.isfinite(dist).all()):
        fail(f"{what}: non-finite distances")
    if k > 1 and not bool((dist[:, 1:] >= dist[:, :-1]).all()):
        fail(f"{what}: distances not ascending")
    if not bool((comps > 0).all()):
        fail(f"{what}: zero comparisons")


def phase_main_path(seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib
    from repro_torch.data import synthetic

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    pool = synthetic.fashion_like(CORPUS + QUERIES, seed=seed)
    corpus, queries = pool[:CORPUS], pool[CORPUS:]
    data_s = time.perf_counter() - t0
    n = corpus.shape[0]
    k, batch = 10, BATCH
    search_kw = dict(budget=1024, rerank=256, mode="auto")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, build_counts = counted(lambda: index_lib.build("infinity", corpus, {},
                                                          device=dev))
    build_s = time.perf_counter() - t0
    require(build_counts, {"topk": (1,), "pdist": (1,), "qpath/minmax": NUM_HOPS,
                           "qpath/minplus": 0, "qpath/logminplus": 0}, "full-width build")
    Qt = torch.as_tensor(queries, device=dev)
    t0 = time.perf_counter()
    (_, gt), gt_counts = counted(lambda: scan_lib.topk_scan(Qt, index.X, k=k,
                                                            metric="euclidean"))
    gt_s = time.perf_counter() - t0
    require(gt_counts, {"topk": (1,)}, "ground truth")

    def serve():
        # first batch: also flattens the tree for the beam (lazy)
        t0 = time.perf_counter()
        first = index.search(Qt[:batch], k=k, **search_kw)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        times, found = [], []
        for start in range(0, Qt.shape[0], batch):
            t0 = time.perf_counter()
            res = index.search(Qt[start:start + batch], k=k, **search_kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            _check_result(res, min(batch, Qt.shape[0] - start), k, n,
                          f"beam batch at {start}")
            found.append(res.idx)
        bf = index.search(Qt[:32], k=k, **search_kw)
        torch.cuda.synchronize()
        _check_result(bf, 32, k, n, "best_first batch")
        desc = index.search(Qt[:batch], k=1, mode="auto")
        torch.cuda.synchronize()
        _check_result(desc, batch, 1, n, "descend batch")
        return first, first_s, times, torch.cat(found), bf, desc

    (first, first_s, times, found, bf, desc), serve_counts = counted(serve)
    peak = torch.cuda.max_memory_allocated()

    full_batches = [t for t, s in zip(times, range(0, Qt.shape[0], batch))
                    if Qt.shape[0] - s >= batch]
    main = {
        "corpus": list(corpus.shape), "queries": int(Qt.shape[0]),
        "config": "IndexConfig() defaults", "search": search_kw | {"k": k},
        "data_seconds": data_s, "build_seconds": build_s,
        "stage_seconds": index.train_history["stage_seconds"],
        "validation": index.train_history["validation"],
        "ground_truth_seconds": gt_s, "first_batch_seconds": first_s,
        "recall@10": _recall(found, gt, k),
        "recall@10_best_first_32": _recall(bf.idx, gt[:32], k),
        "recall@1_descend": _recall(desc.idx, gt[:batch], 1),
        "p50_batch_ms": float(np.median(full_batches)) * 1e3,
        "qps": float(Qt.shape[0] / sum(times)),
        "mean_comparisons_beam": float(first.comparisons.float().mean()),
        "peak_memory_bytes": int(peak),
        "launches": {"build": build_counts, "ground_truth": gt_counts,
                     "serve": serve_counts},
    }
    log("main_path " + json.dumps(main))
    if main["recall@10"] < FULL_RECALL_FLOOR:
        fail(f"full-width beam recall@10 {main['recall@10']} < {FULL_RECALL_FLOOR}")
    if main["recall@10_best_first_32"] < BEST_FIRST_FLOOR:
        fail(f"full-width best-first recall@10 {main['recall@10_best_first_32']} "
             f"< {BEST_FIRST_FLOOR}")
    return main


# ---------------------------------------------------------------------------
# phase 4: recall parity at the bench_infinity config
# ---------------------------------------------------------------------------

def phase_parity(seed: int) -> list[dict]:
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib
    from repro_torch.data import synthetic

    dev = torch.device(DEVICE)
    n, nq, k = 2048, 512, 10
    pool = synthetic.make("manifold", n + nq, seed=seed)
    corpus, queries = pool[:n], pool[n:]
    Qt = torch.as_tensor(queries, device=dev)
    _, gt = scan_lib.topk_scan(Qt, torch.as_tensor(corpus, device=dev), k=k)
    rows = []
    for q, target in BENCH_TARGETS.items():
        t0 = time.perf_counter()
        index, counts = counted(lambda: index_lib.build("infinity", corpus, {
            "q": q, "proj_sample": 512, "train_steps": 300,
            "budget": 1024, "rerank": 256,
        }, device=dev))
        build_s = time.perf_counter() - t0
        sweeps, idle = (("qpath/minmax", "qpath/logminplus") if math.isinf(q)
                        else ("qpath/logminplus", "qpath/minmax"))
        require(counts, {"topk": (1,), "pdist": (1,), sweeps: NUM_HOPS, idle: 0,
                         "qpath/minplus": 0}, f"bench-config build q={q}")
        res = index.search(Qt, k=k)
        torch.cuda.synchronize()
        _check_result(res, nq, k, n, f"bench config q={q}")
        rec = _recall(res.idx, gt, k)
        row = {"q": "inf" if math.isinf(q) else f"{q:g}", "beam_recall@10": rec,
               "target": target, "build_seconds": build_s,
               "validation": index.train_history["validation"],
               "launches": counts}
        rows.append(row)
        log("parity " + json.dumps(row))
        if abs(rec - target) > RECALL_SLACK:
            fail(f"beam recall@10 {rec} at q={q} is not within {RECALL_SLACK} "
                 f"of {target}")
    return rows


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build  # fails outside a checkout

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    env = phase_environment(_build.build())
    rows = phase_kernels(args.seed)
    main_path = phase_main_path(args.seed)
    parity = phase_parity(args.seed)

    windows = {"full-width build": main_path["launches"]["build"],
               "full-width ground truth": main_path["launches"]["ground_truth"]}
    windows.update({f"bench-config build q={p['q']}": p["launches"] for p in parity})
    kernels = []
    for row in rows:
        path = row["path"]
        kernels.append({
            "name": row["name"], "case": row["case"], "route": "cuda",
            "source": row["source"], "replaces": row["replaces"],
            "path": path or "none: no build sweeps in this mode",
            "launches": windows[path][row["counter"]] if path else 0,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"]["ms"],
            "bound_by": row["bound"]["by"], "library_ms": row["library_ms"],
        })
    log(f"seconds total {time.perf_counter() - t_start:.3f} "
        f"nvcc build {env['build_seconds']:.3f}")
    log(env["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
