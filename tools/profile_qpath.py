#!/usr/bin/env python3
"""What the qpath kernel's exact skip and its split plan buy, on one CUDA
card, at the shapes the builds give it.

    python3 tools/profile_qpath.py [--seed 0] [--baseline DIR] [--out FILE]

Run from the root of the repo.  The operands are recorded from real
builds, as ``chip_smoke.py`` records them: the six logminplus sweeps of the
bench-config q=2 build ((512, 512) each), the six of the infinity
retrieval's build ((1000, 1000)), the six minmax sweeps of the full-width
build ((2048, 2048)), and the first and last of ``chip_smoke.py``'s fixed
2048^3 logminplus operands (the ``fashion_like`` kNN graph).  For each
sweep it prints one JSON line:

- ``evaluated`` (logminplus): the share of (i, j, k) whose logaddexp the
  kernel evaluates, from a counting variant of ``csrc/qpath.cu``;
- ``ms``: the kernel as built and its variants, each timed in forward then
  reverse order (both means kept): ``unpruned`` (``SKIP = false``: every
  combine evaluated), ``waves_<w>`` (logminplus with
  ``kernels/qpath/qpath.py:WAVES`` set to w: the k splits), and
  ``baseline`` where ``--baseline`` names a directory holding an earlier
  ``qpath.cu`` and its ``common.cuh`` whose C entry is ``qpath_f32(A, B,
  C, m, kd, n, mode, stream)`` (the first design's; e.g. that file's
  directory unpacked from an earlier commit under ``build/``);
- every variant's result is held bit for bit to the built kernel's (the
  script fails otherwise, except the baseline, whose agreement is
  reported), and ``plain_max_abs_err`` against ``kernels/qpath/ref.py``.

Then one ``build`` line per build: each variant's time summed over the
build's sweeps (the first of its two means).  The variants are built from
copies of the source under ``build/qpath_variants/``.  The line before the
last is the card's name and power limit as ``nvidia-smi`` gives them; the
last is one JSON object of every line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))

from chip_smoke import (  # noqa: E402
    BENCH_N, BENCH_Q, INF_INDEX, NUM_HOPS, SUBSET, _full_width_data, cuda_ms,
    inf_candidates, recorded_sweeps,
)

SKIP = "constexpr bool SKIP = true;"
#: the counting variant's reader, appended to its source
TAKE_COUNT = """
extern "C" int qpath_evaluated_take(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, qpath_evaluated, sizeof(*out));
  const unsigned long long zero = 0;
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(qpath_evaluated, &zero, sizeof(zero));
  return static_cast<int>(err);
}
"""
#: name -> (old text, new text) edits of csrc/qpath.cu
VARIANTS = {
    "built": [],
    "unpruned": [(SKIP, "constexpr bool SKIP = false;")],
    # the built kernel, counting the combines it evaluates
    "counting": [
        ("// The block's (m, n) tile over k",
         "__device__ unsigned long long qpath_evaluated;\n\n// The block's (m, n) tile over k"),
        ("  const int kbeg = blockIdx.z * k_per_split;",
         "  unsigned long long evaluated = 0;\n  const int kbeg = blockIdx.z * k_per_split;"),
        ("            // a dense step: the whole tile, as the unpruned kernel does",
         "            evaluated += TM * TN;"),
        ("              *p = fminf(*p, c);", "              *p = fminf(*p, c);\n              ++evaluated;"),
        ("  rt::cp_wait<0>();\n\n  const bool vec_out",
         "  rt::cp_wait<0>();\n  if (evaluated) atomicAdd(&qpath_evaluated, evaluated);\n\n"
         "  const bool vec_out"),
    ],
}
WAVES = (1, 4, 8, 16)
BASELINE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def build_variants(variants: dict, baseline: str | None) -> dict:
    """Compile each variant's qpath.cu (with runtime.cu for the error
    strings), and the baseline's, all nvcc processes at once, and link one
    library each.  Returns name -> CDLL."""
    from repro_torch.kernels import _build

    root = _build.BUILD_DIR / "qpath_variants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    text = (_build.CSRC / "qpath.cu").read_text()
    nvcc = _build._nvcc()
    runtime = root / "runtime.o"
    jobs = {"runtime": (runtime, subprocess.Popen(
        [nvcc, *_build.CFLAGS, "-c", str(_build.CSRC / "runtime.cu"), "-o", str(runtime)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))}
    sources = {}
    for name, edits in variants.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not once in qpath.cu")
            src = src.replace(old, new)
        sources[name] = (src + TAKE_COUNT if name == "counting" else src,
                         _build.CSRC / "common.cuh")
    if baseline:
        sources["baseline"] = (open(os.path.join(baseline, "qpath.cu")).read(),
                               os.path.join(baseline, "common.cuh"))
    for name, (src, header) in sources.items():
        vdir = root / name
        vdir.mkdir()
        (vdir / "qpath.cu").write_text(src)
        shutil.copy(header, vdir / "common.cuh")
        obj = vdir / "qpath.o"
        jobs[name] = (obj, subprocess.Popen(
            [nvcc, *_build.CFLAGS, "-c", str(vdir / "qpath.cu"), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in jobs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{report}")
    libs = {}
    for name in sources:
        so = root / name / "lib.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", str(jobs[name][0]),
                        str(runtime), "-o", str(so)],
                       check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        lib = ctypes.CDLL(str(so))
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [ctypes.c_int]
        libs[name] = lib
    return libs


def build_operands(seed: int) -> dict:
    """Build -> the operands of its sweeps, recorded from real builds (the
    kernel computes the sweeps): build name -> [(mode, A)]."""
    import torch

    from repro_torch import configs
    from repro_torch.core import index as index_lib
    from repro_torch.core.search import IndexConfig, InfinityIndex
    from repro_torch.data import synthetic

    dev = torch.device("cuda")
    builds = {
        "bench-config build q=2": lambda: index_lib.build(
            "infinity", synthetic.make("manifold", BENCH_N + BENCH_Q, seed=seed)[:BENCH_N],
            {"q": 2.0, "proj_sample": 512, "train_steps": 300}, device=dev),
        "infinity retrieval": lambda: InfinityIndex.build(
            inf_candidates(configs.get("deepfm"), seed, dev), IndexConfig(**INF_INDEX),
            device=dev),
        "full-width build": lambda: index_lib.build(
            "infinity", _full_width_data(seed)[0], {}, device=dev),
    }
    out = {}
    for name, build in builds.items():
        seen = []
        with recorded_sweeps(seen):
            build()
        if len(seen) != NUM_HOPS or any(B is not None for _, _, B in seen):
            raise SystemExit(f"{name}: recorded {len(seen)} sweeps, want {NUM_HOPS} squares")
        out[name] = [(mode, A) for mode, A, _ in seen]
    return out


def smoke_operands(seed: int) -> list:
    """chip_smoke.py's fixed 2048^3 logminplus operands: the first sweep's
    (2 log of the kNN-graph edge matrix of fashion_like S) and the last
    sweep's (after five doublings, by the plain version)."""
    import torch

    from repro_torch.core import knn_graph as knn_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels.pdist.ref import pdist_ref
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref

    S = torch.as_tensor(synthetic.fashion_like(SUBSET, seed=seed), device="cuda")
    eye = torch.eye(SUBSET, dtype=torch.bool, device="cuda")
    idx, _ = knn_lib.knn_graph(S, k=16, metric="euclidean")
    mask = knn_lib.knn_mask(idx, SUBSET)
    D = torch.where(eye, 0.0, pdist_ref(S, S, metric="euclidean"))
    M = 2.0 * torch.log(torch.where(mask | mask.T | eye, D, float("inf")))
    first = M
    for _ in range(NUM_HOPS - 1):
        M = torch.minimum(M, qpath_matmul_ref(M, M, mode="logminplus"))
    return [("logminplus", first), ("logminplus", M)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="directory of an earlier qpath.cu and common.cuh to time beside")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_qpath: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build
    from repro_torch.kernels.qpath import qpath as qpath_mod
    from repro_torch.kernels.qpath.ref import qpath_matmul_ref

    _build.build()
    libs = build_variants(VARIANTS, args.baseline)
    built = _build._STATE["lib"]
    take = libs["counting"].qpath_evaluated_take
    take.argtypes = [ctypes.c_void_p]
    count = ctypes.c_ulonglong(0)
    waves0 = qpath_mod.WAVES["logminplus"]

    def use(name: str, waves: int = waves0):
        _build._STATE["lib"] = libs[name]
        _build._RESIDENT.clear()
        qpath_mod.WAVES["logminplus"] = waves

    def baseline_call(A, mode):
        fn = libs["baseline"].qpath_f32
        fn.argtypes, fn.restype = BASELINE_ARGTYPES, ctypes.c_int
        out = torch.empty_like(A)
        m, kd = A.shape
        err = fn(A.data_ptr(), A.data_ptr(), out.data_ptr(), m, kd, A.shape[1],
                 qpath_mod.MODE_CODES[mode], _build.stream_handle(A.device))
        if err:
            raise SystemExit(f"baseline qpath_f32: CUDA error {err}")
        return out

    cases = [(name, t, mode, A) for name, ops in build_operands(args.seed).items()
             for t, (mode, A) in enumerate(ops)]
    cases += [(f"fashion_like {SUBSET} fixed", t, mode, A)
              for t, (mode, A) in zip((0, NUM_HOPS - 1), smoke_operands(args.seed))]
    lines = []
    totals = {}
    for build, t, mode, A in cases:
        n = A.shape[0]
        calls = {"built": lambda: qpath_mod.qpath_matmul_cuda(A, A, mode=mode)}
        setups = {"built": ("built",)}
        if mode == "logminplus":
            calls["unpruned"] = calls["built"]
            setups["unpruned"] = ("unpruned",)
            for w in WAVES:
                if w != waves0:
                    calls[f"waves_{w}"] = calls["built"]
                    setups[f"waves_{w}"] = ("built", w)
        if args.baseline:
            calls["baseline"] = lambda: baseline_call(A, mode)
            setups["baseline"] = ("built",)
        outs = {}
        for name, call in calls.items():
            use(*setups[name])
            outs[name] = call()
        row = {"build": build, "sweep": t, "mode": mode, "shape": [n, n, n],
               "finite_share": float(torch.isfinite(A).float().mean())}
        if mode == "logminplus":
            use("counting")
            _build.check(take(ctypes.byref(count)), "qpath_evaluated_take")
            outs["counting"] = calls["built"]()
            torch.cuda.synchronize()
            _build.check(take(ctypes.byref(count)), "qpath_evaluated_take")
            row["evaluated"] = count.value / float(n) ** 3
        for name, out in outs.items():
            if name != "baseline" and not torch.equal(out, outs["built"]):
                raise SystemExit(f"{build} sweep {t}: {name} is not bit-identical to the "
                                 "built kernel")
        if args.baseline:
            row["baseline_bit_identical"] = bool(torch.equal(outs["baseline"], outs["built"]))
        ref = qpath_matmul_ref(A, A, mode=mode)
        fin = torch.isfinite(ref)
        row["plain_max_abs_err"] = float((outs["built"][fin] - ref[fin]).abs().max())
        reps = 20 if n <= 1024 else 5
        order = list(calls) + list(reversed(calls))
        times = {name: [] for name in calls}
        for name in order:
            use(*setups[name])
            times[name].append(cuda_ms(calls[name], reps))
        use("built")
        _build._STATE["lib"] = built
        row["ms"] = times
        lines.append(row)
        print(json.dumps(row), flush=True)
        acc = totals.setdefault(build, {"build": build, "mode": mode, "sweeps": 0, "ms": {}})
        acc["sweeps"] += 1
        for name, (first, _) in times.items():
            acc["ms"][name] = acc["ms"].get(name, 0.0) + first
    for acc in totals.values():
        lines.append(acc)
        print(json.dumps(acc), flush=True)
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
