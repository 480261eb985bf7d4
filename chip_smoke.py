#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit (as ``nvidia-smi`` reports
   them), torch and CUDA versions, the nvcc build of ``src/repro_torch/
   csrc`` and each kernel's registers and shared memory (``-Xptxas -v``).
2. Every kernel against its plain PyTorch version at the main path's
   shapes: pdist 2048x2048x784 (euclidean, manhattan, chebyshev); topk for
   the kNN graph (2048x2048x784, k=16, self excluded; euclidean, manhattan,
   chebyshev) and the ground truth (10000x60000x784, k=10; euclidean,
   manhattan); the int8 topk for one quantized-brute serve batch
   (512x60000x784, K=64) and the whole query set (10000x60000x784); qpath
   2048^3 in all three modes.  Each prints its error, id agreement, the
   kernel's time (CUDA events after warm-up), the plain version's time, the
   time of one PyTorch call that computes the same function where there is
   one, and the bound (the least time the card could take).
3. The main path at full width: an ``InfinityIndex`` with ``IndexConfig()``
   defaults over 60000 x 784 ``fashion_like`` vectors (the shape of
   Fashion-MNIST), 10000 queries served in batches of 512 (beam), one batch
   of 32 (best-first) and one k=1 search (descent).  Launch counters are
   zeroed just before and read just after each window: the build must
   launch the f32 topk (kNN graph), the matmul pdist and six minmax sweeps;
   the ground-truth scan, the f32 topk; the serving window is reported.
   Beam recall@10 must reach ``FULL_RECALL_FLOOR`` and best-first
   ``BEST_FIRST_FLOOR``.
4. Recall parity with the committed JAX figures at the ``bench_infinity``
   config (manifold, n=2048, 512 queries): beam recall@10 within 0.03 of
   0.999 at q=2 and 0.939 at q=inf.  Each build is a counted window: six
   logminplus sweeps at q=2, six minmax sweeps at q=inf.
5. Quantized serving at full width, over phase 3's corpus and queries
   (batches of 512, k=10): ``brute`` in f32 (recall@10 1.0 up to near
   ties, one f32 topk launch per batch), ``brute`` with ``{"quant": True}``
   (recall@10 >= 0.99, one int8 topk launch per batch and no f32 scan), and
   phase 3's infinity index with a ``QuantStore`` attached (beam, budget
   1024, rerank 256: overlap >= 0.9 with its own f32 answers, no topk
   launch).  Each prints p50 batch ms, QPS, mean comparisons and the
   corpus bytes it reads per query.  One bench-config build goes through
   the registry's ``quant`` key.
6. The manhattan path at full width: ``IndexConfig(metric="manhattan")``
   over the same corpus.  Its build must launch the cube topk and pdist
   once each, six minmax sweeps and no f32 regime; its ground truth is the
   cube topk; beam, best-first and descent serve it, reranking in
   manhattan.  Beam recall@10 must reach ``MANHATTAN_RECALL_FLOOR`` and
   best-first ``MANHATTAN_BEST_FIRST_FLOOR``.

The line before the last is a JSON object listing every kernel row, each
with the launches of the window that runs it (``path``); the last is
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

# H100 SXM published peaks (dense): f32 on the CUDA cores, int8 on the
# tensor cores, HBM bandwidth.
F32_FLOPS = 67e12  # an FMA counts as two flops
F32_INSTR = F32_FLOPS / 2  # f32 lane instructions per second
INT8_OPS = 1979e12
# special-function units: 16 per SM per clock, 132 SMs at 1.98 GHz
SFU_OPS = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12

DEVICE = "cuda"
# main-path shapes: the projection subset (IndexConfig().proj_sample), the
# Fashion-MNIST corpus and query set, the serving batch
SUBSET, CORPUS, QUERIES, BATCH = 2048, 60000, 10000, 512

# tests/test_kernels.py:50 tolerance; manhattan sums d terms in another
# order than its plain version and is held to the same
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 5e-4
INT8_TOL = 1e-4  # tests/test_quant.py:108-110
K_QUANT = 64  # quant.shortlist_width(10, 60000): the int8 first pass's width
LOGMINPLUS_ATOL = 1e-5
BENCH_TARGETS = {2.0: 0.999, math.inf: 0.939}  # experiments/BENCH_infinity.json
RECALL_SLACK = 0.03
# Full width: beam recall@10 read 0.0654 and best-first 0.084 on an H100
# with this data (fashion_like falls ~2x per doubling of n at budget 1024 in both
# packages: tests/torch_recall_ladder.py).  The floors sit well above what
# a search that returned unrelated rows would score (~256 / 60000).
FULL_RECALL_FLOOR = 0.045
BEST_FIRST_FLOOR = 0.03
# Quantized serving: JAX's contract for quantized brute
# (tests/test_quant.py:137-145) and for the infinity prefilter's overlap
# with the f32 answers (tests/test_quant.py:202).
QUANT_BRUTE_FLOOR = 0.99
QUANT_OVERLAP_FLOOR = 0.9
# Manhattan at full width: beam recall@10 read 0.06679 and best-first (32
# queries) 0.0594 on an H100 with this data; the beam floor is 70 % of the
# reading, the best-first one that of euclidean (32 queries move it in
# steps of 1/320).  At n=4000 the two packages agree (0.7539 JAX, 0.7559
# port, reduced config, CPU: tests/torch_recall_ladder.py --metric
# manhattan), and on the card the port's recall halves per doubling of n
# as in euclidean (0.767 at 4000, 0.223 at 16000).
MANHATTAN_RECALL_FLOOR = 0.047
MANHATTAN_BEST_FIRST_FLOOR = 0.03
NUM_HOPS = 6  # IndexConfig().num_hops: qpath sweeps per build
K = 10  # every serving phase answers top-10
SEARCH_KW = dict(budget=1024, rerank=256, mode="auto")
BENCH_N, BENCH_Q = 2048, 512  # benchmarks/bench_infinity.py defaults
# the window whose launch count each qpath mode reports: q=inf builds sweep
# in minmax, finite-q builds in logminplus; no build sweeps in minplus
QPATH_PATHS = {"minmax": "full-width build", "minplus": None,
               "logminplus": "bench-config build q=2"}
NO_CHEBYSHEV = "none: no chebyshev window on the main path"
#: every launch counter, zero unless a window requires otherwise
COUNTERS = ("topk/f32", "topk/cube", "topk/int8", "pdist/matmul", "pdist/cube",
            "qpath/minplus", "qpath/minmax", "qpath/logminplus")


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
    """Each ``want`` entry is an exact count, or (lo,) for at least lo; a
    counter ``want`` does not name must read 0."""
    for name in COUNTERS:
        n = want.get(name, 0)
        ok = counts[name] >= n[0] if isinstance(n, tuple) else counts[name] == n
        if not ok:
            fail(f"{what}: launch counts {counts}, want {name} "
                 + (f">= {n[0]}" if isinstance(n, tuple) else f"== {n}"))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls after
    one warm-up call (``warmup``), by CUDA events."""
    import torch

    if warmup:
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


def close_matmul(out, ref, rtol=MATMUL_RTOL, atol=MATMUL_ATOL):
    """max |out - ref| and whether every entry is within the tolerance
    (by default the matmul family's, rtol 1e-5, atol 5e-4); infinities
    must coincide."""
    import torch

    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(out)):
        return float("inf"), False
    err = (out[fin] - ref[fin]).abs()
    ok = bool((err <= atol + rtol * ref[fin].abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


def ids_agree(ids, ref_ids, ref_d, k: int, rtol=MATMUL_RTOL, atol=MATMUL_ATOL):
    """Kernel ids against the plain version's (computed with k+1 columns):
    every mismatch must sit on a near tie, i.e. the plain distance at that
    position is within tolerance of a neighbouring rank's distance.
    Returns (share of identical ids, ok)."""
    import torch

    ids = ids.long()
    ref = ref_ids[:, :k].long()
    same = ids == ref
    d = ref_d
    tol = atol + rtol * d.abs()
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
            for short in ("pdist_kernel", "topk_int8_kernel", "topk_kernel",
                          "qpath_kernel"):
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
    from repro_torch.core import quant as quant_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels.pdist.pdist import pdist_cuda
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.qpath.qpath import qpath_matmul_cuda
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref
    from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref, topk_ref
    from repro_torch.kernels.topk.topk import topk_cuda, topk_quant_cuda

    dev = torch.device(DEVICE)
    rows = []

    # pdist: D on the projection subset.  Compared as the build uses it,
    # with the diagonal set to 0: a self-distance is sqrt of f32 rounding
    # noise in |x|^2 + |x|^2 - 2 x.x (~1e-2 at these norms) in both
    # versions; its error is reported apart.  The cube metrics compute
    # |x - x| = 0 exactly on the diagonal.
    S = torch.as_tensor(synthetic.fashion_like(SUBSET, seed=seed), device=dev)
    m = n = S.shape[0]
    d = S.shape[1]
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    for metric, path, lib in (
        ("euclidean", "full-width build", lambda: torch.cdist(S, S)),
        ("manhattan", "manhattan build", lambda: torch.cdist(S, S, p=1.0)),
        ("chebyshev", None, lambda: torch.cdist(S, S, p=float("inf"))),
    ):
        cube = metric != "euclidean"
        out = pdist_cuda(S, S, metric=metric)
        ref = pdist_ref(S, S, metric=metric)
        diag_err = float((out.diagonal() - ref.diagonal()).abs().max())
        if metric == "chebyshev":
            err, ok = float((out - ref).abs().max()), torch.equal(out, ref)
        else:
            err, ok = close_matmul(torch.where(eye, 0.0, out), torch.where(eye, 0.0, ref))
        if not ok:
            fail(f"pdist {metric} disagrees with its plain version (max err {err})")
        rows.append({
            "name": "pdist", "case": f"D on S {m}x{n}x{d} {metric}",
            "path": path, "idle": None if path else NO_CHEBYSHEV,
            "counter": "pdist/cube" if cube else "pdist/matmul",
            "source": "src/repro_torch/csrc/pdist.cu",
            "replaces": "src/repro/kernels/pdist/pdist.py:"
                        + ("67" if cube else "36"),
            "max_abs_err": err, "diagonal_abs_err": diag_err,
            "ms": cuda_ms(lambda: pdist_cuda(S, S, metric=metric), 20),
            "plain_ms": cuda_ms(lambda: pdist_ref(S, S, metric=metric), 3 if cube else 20),
            "library_ms": cuda_ms(lib, 5 if cube else 20),
            "bound": (_bound(ops=2 * m * n * d, rate=F32_INSTR,
                             nbytes=4 * (m * d + n * d + m * n)) if cube else
                      _bound(ops=2 * m * n * d, rate=F32_FLOPS,
                             nbytes=4 * (m * d + n * d + m * n))),
        })
        log("kernel " + json.dumps(rows[-1]))

    # topk: the kNN graph of S, then the ground truth of the full corpus,
    # for the matmul family (euclidean) and the cube family
    pool = torch.as_tensor(synthetic.fashion_like(CORPUS + QUERIES, seed=seed),
                           device=dev)
    corpus, queries = pool[:CORPUS], pool[CORPUS:]
    slice_q = queries[:BATCH]
    for case, path, metric, Xq, Y, k, excl in (
        ("kNN graph", "full-width build", "euclidean", S, S, 16, True),
        ("ground truth", "full-width ground truth", "euclidean", queries, corpus, 10, False),
        ("kNN graph", "manhattan build", "manhattan", S, S, 16, True),
        ("ground truth", "manhattan ground truth", "manhattan", queries, corpus, 10, False),
        ("kNN graph", None, "chebyshev", S, S, 16, True),
    ):
        cube = metric != "euclidean"
        m, n, d = Xq.shape[0], Y.shape[0], Xq.shape[1]
        od, oi = topk_cuda(Xq, Y, k=k, metric=metric, exclude_self=excl)
        # the cube ground truth is held against its plain version on one
        # serve batch of queries: the plain (rows, 4096, 784) cube panels
        # of all 10000 take seconds
        held = BATCH if (cube and m > SUBSET) else m
        rd, ri = topk_ref(Xq[:held], Y, k=k + 1, metric=metric, exclude_self=excl)
        od, oi = od[:held], oi[:held]
        if metric == "chebyshev":
            err = float((od - rd[:, :k]).abs().max())
            ok = ids_ok = torch.equal(od, rd[:, :k]) and torch.equal(oi, ri[:, :k])
            same = float((oi == ri[:, :k]).float().mean())
        else:
            err, ok = close_matmul(od, rd[:, :k])
            same, ids_ok = ids_agree(oi, ri, rd, k)
        if not (ok and ids_ok):
            fail(f"topk {metric} ({case}) disagrees with its plain version "
                 f"(max err {err}, identical ids {same})")
        p = 1.0 if metric == "manhattan" else (float("inf") if cube else 2.0)
        big = m > SUBSET
        reps = 3 if big else 10
        once = big and cube  # plain and cdist take seconds here: one call
        rows.append({
            "name": "topk", "case": f"{case} {m}x{n}x{d} k={k} {metric}"
                                    + (" exclude_self" if excl else "")
                                    + (f" (held to plain on {held} queries)"
                                       if held < m else ""),
            "path": path, "idle": None if path else NO_CHEBYSHEV,
            "counter": "topk/cube" if cube else "topk/f32",
            "source": "src/repro_torch/csrc/topk.cu",
            "replaces": "src/repro/kernels/topk/topk.py:" + ("171" if cube else "123"),
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_cuda(Xq, Y, k=k, metric=metric,
                                            exclude_self=excl), 1 if once else reps),
            "plain_ms": cuda_ms(lambda: topk_ref(Xq, Y, k=k, metric=metric,
                                                 exclude_self=excl),
                                1 if once else reps, warmup=not once),
            "library_ms": cuda_ms(lambda: torch.topk(torch.cdist(Xq, Y, p=p), k, dim=1,
                                                     largest=False),
                                  1 if once else reps, warmup=not once),
            "bound": (_bound(ops=2 * m * n * d, rate=F32_INSTR,
                             nbytes=4 * (m * d + n * d) + 8 * m * k) if cube else
                      _bound(ops=2 * m * n * d, rate=F32_FLOPS,
                             nbytes=4 * (m * d + n * d) + 8 * m * k)),
        })
        log("kernel " + json.dumps(rows[-1]))

    # int8 topk: the quantized brute first pass (K = shortlist_width(10, n))
    # over the corpus's codes, for one serve batch and the whole query set
    codes, scales, sqn = quant_lib.QuantStore.build(corpus).device_view()
    n, d = codes.shape
    for case, Xq in (("serve batch", slice_q), ("whole query set", queries)):
        m = Xq.shape[0]
        od, oi = topk_quant_cuda(Xq, codes, scales, sqn, k=K_QUANT)
        rd, ri = topk_quant_ref(Xq, codes, scales, sqn, k=K_QUANT + 1)
        err, ok = close_matmul(od, rd[:, :K_QUANT], rtol=INT8_TOL, atol=INT8_TOL)
        same, ids_ok = ids_agree(oi, ri, rd, K_QUANT, rtol=INT8_TOL, atol=INT8_TOL)
        if not (ok and ids_ok):
            fail(f"topk int8 ({case}) disagrees with its plain version "
                 f"(max err {err}, identical ids {same})")

        def library():
            # the same function by PyTorch's int8 GEMM (cuBLASLt) + topk
            xq, alpha, xn = quantize_queries(Xq, scales)
            acc = torch._int_mm(xq, codes.T)
            d2 = (xn[:, None] + sqn[None, :] - 2.0 * (acc.float() * alpha[:, None]))
            return torch.topk(torch.sqrt(d2.clamp_min(0.0)), K_QUANT, dim=1,
                              largest=False)

        reps = 20 if m == BATCH else 3
        rows.append({
            "name": "topk_int8", "case": f"quantized brute {case} {m}x{n}x{d} "
                                         f"K={K_QUANT} euclidean",
            "path": "quantized brute serve", "counter": "topk/int8",
            "source": "src/repro_torch/csrc/topk_int8.cu",
            "replaces": "src/repro/kernels/topk/topk.py:207",
            "max_abs_err": err, "ids_identical": same,
            "ms": cuda_ms(lambda: topk_quant_cuda(Xq, codes, scales, sqn, k=K_QUANT), reps),
            "plain_ms": cuda_ms(lambda: topk_quant_ref(Xq, codes, scales, sqn, k=K_QUANT),
                                reps),
            "library_ms": cuda_ms(library, reps),
            "bound": _bound(ops=2 * m * n * d, rate=INT8_OPS,
                            nbytes=m * d + n * d + 4 * (2 * m + n) + 8 * m * K_QUANT),
        })
        log("kernel " + json.dumps(rows[-1]))
    del pool, corpus, queries, codes

    # qpath: the first sweep's operands of the projection (E = D on the
    # symmetrised kNN graph + diagonal, +inf elsewhere)
    idx, _ = knn_lib.knn_graph(S, k=16, metric="euclidean")
    mask = knn_lib.knn_mask(idx, S.shape[0])
    D = torch.where(eye, 0.0, pdist_ref(S, S, metric="euclidean"))
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
            "path": QPATH_PATHS[mode],
            "idle": None if QPATH_PATHS[mode] else "none: no build sweeps in this mode",
            "counter": f"qpath/{mode}",
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
# serving helpers (phases 3-6)
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


def _serve(search, Qt, n: int, what: str):
    """Serve ``Qt`` in batches of ``BATCH`` through ``search``, each batch
    synchronised and checked.  Returns (seconds per batch, ids, dists,
    comparisons) over all queries."""
    import torch

    times, ids, dists, comps = [], [], [], []
    for start in range(0, Qt.shape[0], BATCH):
        t0 = time.perf_counter()
        res = search(Qt[start:start + BATCH])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _check_result(res, min(BATCH, Qt.shape[0] - start), K, n, f"{what} batch at {start}")
        ids.append(res.idx)
        dists.append(res.dist)
        comps.append(res.comparisons)
    return times, torch.cat(ids), torch.cat(dists), torch.cat(comps)


def _rates(times: list, queries: int) -> dict:
    """p50 over the full batches and QPS over all of them."""
    import numpy as np

    full = [t for t, s in zip(times, range(0, queries, BATCH)) if queries - s >= BATCH]
    return {"p50_batch_ms": float(np.median(full)) * 1e3,
            "qps": float(queries / sum(times))}


def _infinity_full_width(label: str, corpus, Qt, cfg: dict, metric: str,
                         build_want: dict, gt_counter: str) -> tuple[dict, dict]:
    """Build an infinity index over ``corpus`` from ``cfg`` (a counted
    window), take the exact ground truth by the topk kernel (a counted
    window), and serve ``Qt``: beam batches, one best-first batch of 32 and
    one k=1 search (a counted window).  Returns (the printed row, the
    state later phases reuse)."""
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import scan as scan_lib

    dev = torch.device(DEVICE)
    n = corpus.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, build_counts = counted(lambda: index_lib.build("infinity", corpus, cfg,
                                                          device=dev))
    build_s = time.perf_counter() - t0
    require(build_counts, build_want, f"{label} build")
    t0 = time.perf_counter()
    (gt_d, gt), gt_counts = counted(lambda: scan_lib.topk_scan(Qt, index.X, k=K,
                                                               metric=metric))
    gt_s = time.perf_counter() - t0
    require(gt_counts, {gt_counter: 1}, f"{label} ground truth")

    def serve():
        # first batch: also flattens the tree for the beam (lazy)
        t0 = time.perf_counter()
        first = index.search(Qt[:BATCH], k=K, **SEARCH_KW)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        beam = _serve(lambda q: index.search(q, k=K, **SEARCH_KW), Qt, n, f"{label} beam")
        bf = index.search(Qt[:32], k=K, **SEARCH_KW)
        torch.cuda.synchronize()
        _check_result(bf, 32, K, n, f"{label} best_first batch")
        desc = index.search(Qt[:BATCH], k=1, mode="auto")
        torch.cuda.synchronize()
        _check_result(desc, BATCH, 1, n, f"{label} descend batch")
        return first, first_s, beam, bf, desc

    (first, first_s, beam, bf, desc), serve_counts = counted(serve)
    peak = torch.cuda.max_memory_allocated()
    times, found, _, comps = beam
    row = {
        "corpus": list(corpus.shape), "queries": int(Qt.shape[0]),
        "config": cfg or "IndexConfig() defaults", "search": SEARCH_KW | {"k": K},
        "build_seconds": build_s,
        "stage_seconds": index.train_history["stage_seconds"],
        "validation": index.train_history["validation"],
        "ground_truth_seconds": gt_s, "first_batch_seconds": first_s,
        "recall@10": _recall(found, gt, K),
        "recall@10_best_first_32": _recall(bf.idx, gt[:32], K),
        "recall@1_descend": _recall(desc.idx, gt[:BATCH], 1),
        **_rates(times, Qt.shape[0]),
        "mean_comparisons_beam": float(comps.float().mean()),
        "peak_memory_bytes": int(peak),
        "launches": {"build": build_counts, "ground_truth": gt_counts,
                     "serve": serve_counts},
    }
    return row, {"index": index, "gt": gt, "gt_d": gt_d, "found": found}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def _full_width_data(seed: int):
    import torch

    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    pool = synthetic.fashion_like(CORPUS + QUERIES, seed=seed)
    data_s = time.perf_counter() - t0
    return pool[:CORPUS], torch.as_tensor(pool[CORPUS:], device=DEVICE), data_s


def phase_main_path(corpus, Qt, data_s: float) -> tuple[dict, dict]:
    main, state = _infinity_full_width(
        "full-width", corpus, Qt, {}, "euclidean",
        {"topk/f32": 1, "pdist/matmul": 1, "qpath/minmax": NUM_HOPS}, "topk/f32")
    main["data_seconds"] = data_s
    log("main_path " + json.dumps(main))
    if main["recall@10"] < FULL_RECALL_FLOOR:
        fail(f"full-width beam recall@10 {main['recall@10']} < {FULL_RECALL_FLOOR}")
    if main["recall@10_best_first_32"] < BEST_FIRST_FLOOR:
        fail(f"full-width best-first recall@10 {main['recall@10_best_first_32']} "
             f"< {BEST_FIRST_FLOOR}")
    return main, state


# ---------------------------------------------------------------------------
# phase 4: recall parity at the bench_infinity config
# ---------------------------------------------------------------------------

def _bench_data(seed: int):
    import torch

    from repro_torch.core import scan as scan_lib
    from repro_torch.data import synthetic

    pool = synthetic.make("manifold", BENCH_N + BENCH_Q, seed=seed)
    corpus, Qt = pool[:BENCH_N], torch.as_tensor(pool[BENCH_N:], device=DEVICE)
    _, gt = scan_lib.topk_scan(Qt, torch.as_tensor(corpus, device=DEVICE), k=K)
    return corpus, Qt, gt


def _bench_build(corpus, Qt, gt, q: float, extra: dict, what: str) -> dict:
    """Build the bench config at q (plus ``extra`` cfg keys) as a counted
    window, search all queries with its defaults and read recall@10."""
    import torch

    from repro_torch.core import index as index_lib

    t0 = time.perf_counter()
    index, counts = counted(lambda: index_lib.build("infinity", corpus, {
        "q": q, "proj_sample": 512, "train_steps": 300,
        "budget": 1024, "rerank": 256, **extra,
    }, device=DEVICE))
    build_s = time.perf_counter() - t0
    sweeps = "qpath/minmax" if math.isinf(q) else "qpath/logminplus"
    require(counts, {"topk/f32": 1, "pdist/matmul": 1, sweeps: NUM_HOPS}, what)
    res = index.search(Qt, k=K)
    torch.cuda.synchronize()
    _check_result(res, Qt.shape[0], K, BENCH_N, what)
    return {"q": "inf" if math.isinf(q) else f"{q:g}",
            "beam_recall@10": _recall(res.idx, gt, K), "build_seconds": build_s,
            "validation": index.train_history["validation"], "launches": counts,
            "quant_store": getattr(index, "quant", None) is not None}


def phase_parity(bench) -> list[dict]:
    rows = []
    for q, target in BENCH_TARGETS.items():
        row = _bench_build(*bench, q, {}, f"bench-config build q={q}")
        row["target"] = target
        rows.append(row)
        log("parity " + json.dumps(row))
        rec = row["beam_recall@10"]
        if abs(rec - target) > RECALL_SLACK:
            fail(f"beam recall@10 {rec} at q={q} is not within {RECALL_SLACK} "
                 f"of {target}")
    return rows


# ---------------------------------------------------------------------------
# phase 5: quantized serving at full width
# ---------------------------------------------------------------------------

def phase_quant(corpus, Qt, main_state: dict, bench, parity: list[dict]) -> list[dict]:
    import torch

    from repro_torch.core import index as index_lib
    from repro_torch.core import quant as quant_lib

    n, d = corpus.shape
    nq = Qt.shape[0]
    batches = -(-nq // BATCH)
    gt, gt_d = main_state["gt"], main_state["gt_d"]
    rows = []

    def row_of(engine, times, ids, comps, counts, scanned) -> dict:
        return {"engine": engine, "corpus": [n, d], "queries": nq, "k": K,
                "recall@10": _recall(ids, gt, K), **_rates(times, nq),
                "mean_comparisons": float(comps.float().mean()),
                "corpus_bytes_per_query": scanned, "launches": counts}

    # brute, f32: the same kernel as the ground truth, batch by batch
    eng = index_lib.build("brute", corpus, {}, device=DEVICE)
    (times, ids, dists, comps), counts = counted(
        lambda: _serve(lambda q: eng.search(q, k=K), Qt, n, "brute f32"))
    require(counts, {"topk/f32": batches}, "brute f32 serve")
    rows.append(row_of("brute", times, ids, comps, counts, 4 * n * d))
    log("quant " + json.dumps(rows[-1]))
    if rows[-1]["recall@10"] < 1.0:
        # only near ties may differ: the returned distances are the truth's
        err, ok = close_matmul(dists, gt_d)
        if not ok:
            fail(f"brute f32 recall@10 {rows[-1]['recall@10']} with distances off "
                 f"the ground truth by {err}")
    del eng

    # brute with the quant key: int8 first pass, exact rerank of K_QUANT
    eng = index_lib.build("brute", corpus, {"quant": True}, device=DEVICE)
    if quant_lib.shortlist_width(K, n) != K_QUANT:
        fail(f"shortlist width {quant_lib.shortlist_width(K, n)} != {K_QUANT}")
    (times, ids, _, comps), counts = counted(
        lambda: _serve(lambda q: eng.search(q, k=K), Qt, n, "brute int8"))
    require(counts, {"topk/int8": batches}, "quantized brute serve")
    rows.append(row_of("brute+quant", times, ids, comps, counts,
                       n * d + 4 * K_QUANT * d))
    log("quant " + json.dumps(rows[-1]))
    if rows[-1]["recall@10"] < QUANT_BRUTE_FLOOR:
        fail(f"quantized brute recall@10 {rows[-1]['recall@10']} < {QUANT_BRUTE_FLOOR}")
    if not bool((comps == n + K_QUANT).all()):
        fail("quantized brute comparisons are not n + K")
    del eng

    # phase 3's infinity index with a store attached (what the quant key
    # does at build): beam buckets on int8 codes of the embedding, the
    # rerank's 256 candidates prefiltered to shortlist_width(10, n) on codes
    index = main_state["index"]
    index_lib.attach_quant_store(index, quant_lib.QuantStore.build(index.X))
    w = quant_lib.shortlist_width(K, n)
    (times, ids, _, comps), counts = counted(
        lambda: _serve(lambda q: index.search(q, k=K, **SEARCH_KW), Qt, n,
                       "infinity+quant"))
    require(counts, {}, "infinity+quant serve")
    row = row_of("infinity+quant", times, ids, comps, counts,
                 d * SEARCH_KW["rerank"] + 4 * d * w)
    row["overlap@10_with_f32"] = _recall(ids, main_state["found"], K)
    row["f32_corpus_bytes_per_query"] = 4 * d * SEARCH_KW["rerank"]
    rows.append(row)
    log("quant " + json.dumps(row))
    if row["overlap@10_with_f32"] < QUANT_OVERLAP_FLOOR:
        fail(f"infinity+quant overlap {row['overlap@10_with_f32']} with its f32 "
             f"answers < {QUANT_OVERLAP_FLOOR}")

    # the registry's quant key at the bench config: within RECALL_SLACK of
    # the same build without it (phase 4, q=inf)
    row = _bench_build(*bench, math.inf, {"quant": True},
                       "bench-config build q=inf quant")
    f32 = next(p for p in parity if p["q"] == "inf")["beam_recall@10"]
    row["engine"], row["f32_beam_recall@10"] = "infinity bench config, quant key", f32
    rows.append(row)
    log("quant " + json.dumps(row))
    if not row["quant_store"] or abs(row["beam_recall@10"] - f32) > RECALL_SLACK:
        fail(f"bench-config quant build: store {row['quant_store']}, recall "
             f"{row['beam_recall@10']} vs f32 {f32}")
    return rows


# ---------------------------------------------------------------------------
# phase 6: the manhattan path at full width
# ---------------------------------------------------------------------------

def phase_manhattan(corpus, Qt) -> dict:
    row, _ = _infinity_full_width(
        "manhattan", corpus, Qt, {"metric": "manhattan"}, "manhattan",
        {"topk/cube": 1, "pdist/cube": 1, "qpath/minmax": NUM_HOPS}, "topk/cube")
    log("manhattan " + json.dumps(row))
    if row["recall@10"] < MANHATTAN_RECALL_FLOOR:
        fail(f"manhattan beam recall@10 {row['recall@10']} < {MANHATTAN_RECALL_FLOOR}")
    if row["recall@10_best_first_32"] < MANHATTAN_BEST_FIRST_FLOOR:
        fail(f"manhattan best-first recall@10 {row['recall@10_best_first_32']} "
             f"< {MANHATTAN_BEST_FIRST_FLOOR}")
    return row


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
    corpus, Qt, data_s = _full_width_data(args.seed)
    main_path, main_state = phase_main_path(corpus, Qt, data_s)
    bench = _bench_data(args.seed)
    parity = phase_parity(bench)
    quant = phase_quant(corpus, Qt, main_state, bench, parity)
    del main_state
    manhattan = phase_manhattan(corpus, Qt)

    windows = {"full-width build": main_path["launches"]["build"],
               "full-width ground truth": main_path["launches"]["ground_truth"],
               "manhattan build": manhattan["launches"]["build"],
               "manhattan ground truth": manhattan["launches"]["ground_truth"]}
    windows.update({f"bench-config build q={p['q']}": p["launches"] for p in parity})
    windows["quantized brute serve"] = next(
        r["launches"] for r in quant if r["engine"] == "brute+quant")
    kernels = []
    for row in rows:
        path = row["path"]
        kernels.append({
            "name": row["name"], "case": row["case"], "route": "cuda",
            "source": row["source"], "replaces": row["replaces"],
            "path": path or row["idle"],
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
