#!/usr/bin/env python3
"""Where the embedding bag's time goes on one CUDA card, at the shapes the
recsys windows give it, and what each design choice of ``csrc/bag.cu``
buys.

    python3 tools/profile_bag.py [--seed 0] [--baseline DIR] [--out FILE]

Run from the root of the repo.  The inputs are ``chip_smoke.bag_inputs``'s:
DeepFM's full-width tables and the ids phase 7 serves — the first-order
term at serve_bulk (262144 x 39, D = 1) and serve_p99 (512 x 39), the user
embeddings of retrieval_cand (1 x 39, D = 10) and of the infinity
retrieval (32 x 39) — plus the D = 10 bag at the serve_bulk batch, the
launch floor (one id, D = 1), the first rows of the serve_bulk ids at
batches between (``BETWEEN``: where the warp path should hand over to the
thread path), and the serve_bulk shape with every id 0 (each gather one
cached sector: the kernel's work beside the table's traffic).  For each
shape it prints one JSON line with
``launch_plan``'s choice and, for every variant, the device ms per launch
(``chip_smoke.graph_ms``: a CUDA graph of back-to-back launches, timed in
forward then reverse order, both means kept):

- ``built``: the kernel as ``launch_plan`` launches it;
- ``warp`` / ``thread``: each path forced (``warp_plan``,
  ``thread_plan``): one warp a bag with all its gathers in flight (one
  lane per (s, d), lane d folding), or one thread an output;
- ``chunk_<G>``: the thread path with each instanced chunk G (G = 40 holds
  a whole bag of 39);
- ``threads_<T>``: the thread path in blocks of T threads (bags = T // D);
- ``float2`` (f32, D even): the thread path with two neighbouring outputs
  a thread, one 8-byte load, in chunks of at most 16
  (``tools/bag_variants.cu``);
- ``baseline`` where ``--baseline`` names a directory holding an earlier
  ``bag.cu`` whose C entry is ``bag_f32(table, dtype, ids, weights, out,
  B, S, D, mean, stream)`` (the first design's loop: one thread an output
  walking s, blocks of 256; e.g. that directory unpacked from an earlier
  commit under ``build/``).

Every variant's output is held bit for bit to ``kernels/bag/ref.py`` (the
script fails otherwise).  Then one line of host time a call
(``host_times``).  The variant and the baseline are built under
``build/bag_variants/``.  The line before the last is the card's name and
power limit as ``nvidia-smi`` gives them; the last is one JSON object of
every line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

from chip_smoke import bag_inputs, graph_ms  # noqa: E402

#: the bag_inputs cases profiled, by the start of their case name
SHAPES = ("first-order term, DeepFM serve_bulk", "first-order term, DeepFM serve_p99",
          "user embedding, DeepFM retrieval_cand", "user embeddings, infinity retrieval",
          "pooled embeddings at the serve_bulk batch", "launch floor")
#: batches between serve_p99's and serve_bulk's, (bags, table key)
BETWEEN = ((2048, 1), (4096, 1), (8192, 1), (32768, 1), (65536, 1), (256, 10), (1024, 10),
           (4096, 10))
THREADS = (32, 64, 128, 256)
PTR = ctypes.c_void_p
LL, INT = ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    "bag_float2": [PTR, PTR, PTR, PTR, LL] + [INT] * 7 + [PTR],
    "bag_f32": [PTR, INT, PTR, PTR, PTR, LL, INT, INT, INT, PTR],
}


def build(baseline: str | None) -> dict:
    """Compile ``tools/bag_variants.cu`` (which includes ``csrc/bag.cu``)
    and the baseline's ``bag.cu``, each with ``runtime.cu``, all nvcc
    processes at once; one library each.  Returns name -> CDLL."""
    from repro_torch.kernels import _build

    root = _build.BUILD_DIR / "bag_variants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    nvcc = _build._nvcc()
    sources = {"runtime": (_build.CSRC / "runtime.cu", []),
               "variants": (os.path.join(HERE, "tools", "bag_variants.cu"),
                            ["-I", str(_build.CSRC)])}
    if baseline:
        sources["baseline"] = (os.path.join(baseline, "bag.cu"), ["-I", baseline])
    jobs = {}
    for name, (src, extra) in sources.items():
        obj = root / f"{name}.o"
        jobs[name] = (obj, subprocess.Popen(
            [nvcc, *_build.CFLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{report}")
        if name == "variants":
            print(json.dumps({"ptxas": report[-4000:]}), flush=True)
    libs = {}
    for name in sources:
        if name == "runtime":
            continue
        so = root / f"{name}.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", str(jobs[name][0]),
                        str(jobs["runtime"][0]), "-o", str(so)],
                       check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, name: str):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = ARGTYPES[name], ctypes.c_int
    return fn


def host_times(table, ids, calls: int = 2000, rounds: int = 7) -> dict:
    """Host microseconds a call of a one-id bag, back to back, the card
    synchronised once at the end of each pass (its kernel takes ~2 us, so
    the host is the bound); ``rounds`` passes of every variant, the order
    rotated each round, the median per variant (each pass in
    ``us_rounds``): the public entry ``kernels/bag/ops.embedding_bag`` (the
    wrapper behind the ``dist/roofline`` hook, with no capture open),
    ``embedding_bag_cuda`` (checks, the output's allocation, the plan, the
    stream, the C entry), ``bag_f32`` called directly through ctypes, and
    ``torch.cuda.current_stream`` alone."""
    import time

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.bag import ops as bag_ops
    from repro_torch.kernels.bag.bag import _ARGTYPES, embedding_bag_cuda, launch_plan

    out = torch.empty((1, 1), dtype=torch.float32, device=table.device)
    plan = launch_plan(1, 1, 1, torch.cuda.get_device_properties(0).multi_processor_count)
    fn = _build.function("bag_f32", _ARGTYPES)
    stream = _build.stream_handle(table.device)
    args = (table.data_ptr(), 0, ids.data_ptr(), None, out.data_ptr(), 1, 1, 1, 0,
            plan.threads, plan.bags, plan.chunk, plan.window, int(plan.warp), stream)
    runs = {
        "entry": lambda: bag_ops.embedding_bag(table, ids),
        "wrapper": lambda: embedding_bag_cuda(table, ids),
        "c_entry": lambda: fn(*args),
        "current_stream": lambda: _build.stream_handle(table.device),
    }
    names = list(runs)
    passes = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            run = runs[name]
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            passes[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {"case": "host time a call, one-id bag",
            "us": {name: statistics.median(v) for name, v in passes.items()},
            "us_rounds": passes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="directory of an earlier bag.cu to time beside")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_bag: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build
    from repro_torch.kernels.bag.bag import (
        CHUNKS, SMEM_BYTES, BagPlan, embedding_bag_cuda, launch_plan, staged_words,
        thread_plan, warp_plan,
    )
    from repro_torch.kernels.bag.ref import TABLE_DTYPES, embedding_bag_ref

    _build.build()
    libs = build(args.baseline)
    pairs = entry(libs["variants"], "bag_float2")
    base = entry(libs["baseline"], "bag_f32") if args.baseline else None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tables, cases = bag_inputs(args.seed)
    cases = [c for c in cases if c[0].startswith(SHAPES)]
    bulk = cases[0][2]
    cases += [(f"first rows of the serve_bulk ids, {B} bags", key, bulk[:B], None, "sum",
               None) for B, key in BETWEEN]
    # the serve_bulk batch with every id 0: every gather one cached sector,
    # so the time is the kernel's own work beside the table's traffic
    cases.append(("serve_bulk shape, every id 0", 1, torch.zeros_like(bulk), None, "sum",
                  None))
    lines = []
    for case, key, ids, wts, combine, _ in cases:
        table = tables[key]
        B, S = ids.shape
        D = table.shape[1]
        mean = int(combine == "mean")
        code = TABLE_DTYPES.index(table.dtype)
        weighted = wts is not None
        plan = launch_plan(B, S, D, sms, weighted=weighted)
        thread = thread_plan(B, S, D, sms, weighted=weighted)
        wptr = None if wts is None else wts.data_ptr()
        out = torch.empty((B, D), dtype=torch.float32, device=table.device)

        def raw(fn, *head):
            def call():
                # the stream is read at each call: a CUDA graph captures its own
                err = fn(*head, _build.stream_handle(table.device))
                if err:
                    raise SystemExit(f"{case}: CUDA error {err}")
                return out
            return call

        def forced(p):
            return lambda: embedding_bag_cuda(table, ids, wts, combine=combine, plan=p)

        calls = {"built": forced(plan), "thread": forced(thread)}
        if 4 * S * (D + 2) <= SMEM_BYTES:
            calls["warp"] = forced(warp_plan(B, S, D, sms))
        for g in CHUNKS:
            calls[f"chunk_{g}"] = forced(thread._replace(chunk=g))
        arrays = 2 if weighted else 1
        for t in THREADS:
            bags = max(1, t // D)
            if 4 * staged_words(bags * S) * arrays <= SMEM_BYTES:
                calls[f"threads_{t}"] = forced(BagPlan(t, bags, thread.chunk, S, 0))
        if D % 2 == 0 and table.dtype == torch.float32:
            # chunks of at most 16: 40 float2 a thread spill
            half = thread_plan(B, S, D // 2, sms, weighted=weighted)
            half = half._replace(chunk=min(half.chunk, 16))
            calls["float2"] = raw(pairs, table.data_ptr(), ids.data_ptr(), wptr,
                                  out.data_ptr(), B, S, D, mean, half.threads, half.bags,
                                  half.chunk, half.window)
        if base is not None:
            calls["baseline"] = raw(base, table.data_ptr(), code, ids.data_ptr(), wptr,
                                    out.data_ptr(), B, S, D, mean)
        ref = embedding_bag_ref(table, ids, wts, combine=combine)
        for name, call in calls.items():
            out.fill_(float("nan"))
            got = call()
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise SystemExit(f"{case}: {name} is not bit-identical to the plain version")
        reps = 20 if B * S >= 10 ** 6 else 200
        times = {name: [] for name in calls}
        for name in list(calls) + list(reversed(calls)):
            times[name].append(graph_ms(calls[name], reps))
        row = {"case": f"{case} {B}x{S} D={D} {combine}", "plan": plan._asdict(),
               "blocks": -(-B // plan.bags), "ms": times}
        lines.append(row)
        print(json.dumps(row), flush=True)
    host = host_times(tables[1], bulk[:1, :1])
    lines.append(host)
    print(json.dumps(host), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.out:
        with open(args.out, "w") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
            f.write(smi + "\n")
    print(smi)
    print(json.dumps({"lines": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
