#!/usr/bin/env python3
"""Where the int8 topk kernel's time goes, on one CUDA card.

    python3 tools/profile_topk_int8.py [--seed 0] [--out FILE]

Run from the root of the repo.  At ``chip_smoke.py``'s int8 shapes (the
``fashion_like`` 60000 x 784 corpus as int8 codes, one 512-query serve
batch and the whole 10000-query set, K = 64, euclidean) it reports, as one
JSON line per case:

- ``ms``: the wrapper ``topk_quant_cuda`` as built from the checkout;
- ``no_survivor_ms``: the same call with every column masked, so no
  candidate survives: the copies, the mma loop, the epilogue and the merge
  without selection;
- ``query_prep_ms``: the query preparation the wrapper runs in torch
  (``ref.quantize_queries``);
- ``variants``: the time of each selection variant of
  ``csrc/topk_int8.cu`` (``VARIANTS``), each built from a copy of the
  source with one or two lines changed, under ``build/int8_variants/``.
  Each is held bit for bit to ``topk_quant_ref`` and timed in the order
  of ``VARIANTS``, then again in the reverse order; both means are kept.

The line before the last is the card's name and power limit as
``nvidia-smi`` gives them; the last is one JSON object of every case.
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

from chip_smoke import BATCH, CORPUS, K_QUANT, QUERIES, _ptxas_summary, cuda_ms  # noqa: E402

#: name -> (old line, new line) edits of csrc/topk_int8.cu.  "built" is the
#: source as it stands: rows with fewer than MERGE_MIN survivors in a round
#: are inserted by their owner lanes (insert_sorted_chunked), the others
#: merged by the whole warp (warp_merge).
MERGE_MIN = "constexpr int MERGE_MIN = 8;"
CHUNKED = "insert_sorted_chunked(bd + row * ld"
VARIANTS = {
    "built": [],
    # every row by its owner lane (a round holds at most CAP survivors)
    "owner": [(MERGE_MIN, "constexpr int MERGE_MIN = CAP + 1;")],
    # every row with a survivor by the warp merge
    "warp": [(MERGE_MIN, "constexpr int MERGE_MIN = 1;")],
    # the split at other thresholds
    "merge_min_4": [(MERGE_MIN, "constexpr int MERGE_MIN = 4;")],
    "merge_min_16": [(MERGE_MIN, "constexpr int MERGE_MIN = 16;")],
    # owner lanes with common.cuh's one-entry-at-a-time insert
    "plain_insert": [(CHUNKED, "rt::insert_sorted(bd + row * ld")],
    "owner_plain_insert": [(MERGE_MIN, "constexpr int MERGE_MIN = CAP + 1;"),
                           (CHUNKED, "rt::insert_sorted(bd + row * ld")],
}


def _build_variants() -> dict:
    """Compile each variant's topk_int8.cu (with topk.cu for the merge and
    runtime.cu), all nvcc processes at once, and link one library each.
    Returns name -> (CDLL, ptxas summary of its scan instances)."""
    from repro_torch.kernels import _build

    root = _build.BUILD_DIR / "int8_variants"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    text = (_build.CSRC / "topk_int8.cu").read_text()
    nvcc = _build._nvcc()
    jobs = {}
    for name in ("topk", "runtime"):
        obj = root / f"{name}.o"
        jobs[name] = (obj, subprocess.Popen(
            [nvcc, *_build.CFLAGS, "-c", str(_build.CSRC / f"{name}.cu"), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is not in topk_int8.cu")
            src = src.replace(old, new)
        vdir = root / name
        vdir.mkdir()
        (vdir / "topk_int8.cu").write_text(src)
        shutil.copy(_build.CSRC / "common.cuh", vdir)
        obj = vdir / "topk_int8.o"
        jobs[name] = (obj, subprocess.Popen(
            [nvcc, *_build.CFLAGS, "-c", str(vdir / "topk_int8.cu"), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports = {}
    for name, (_, proc) in jobs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{reports[name]}")
    libs = {}
    for name in VARIANTS:
        so = root / name / "lib.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", str(jobs[name][0]),
                        str(jobs["topk"][0]), str(jobs["runtime"][0]), "-o", str(so)],
                       check=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        lib = ctypes.CDLL(str(so))
        lib.rt_error_string.restype = ctypes.c_char_p
        lib.rt_error_string.argtypes = [ctypes.c_int]
        scans = {k: v for k, v in _ptxas_summary(reports[name]).items()
                 if k.startswith("topk_int8_kernel")}
        libs[name] = (lib, scans)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_topk_int8: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.core import quant as quant_lib
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.topk.ref import quantize_queries, topk_quant_ref
    from repro_torch.kernels.topk.topk import int8_plan, topk_quant_cuda

    dev = torch.device("cuda")
    _build.build()
    libs = _build_variants()
    built_lib = _build._STATE["lib"]
    pool = torch.as_tensor(synthetic.fashion_like(CORPUS + QUERIES, seed=args.seed),
                           device=dev)
    corpus, queries = pool[:CORPUS], pool[CORPUS:]
    codes, scales, sqn = quant_lib.QuantStore.build(corpus).device_view()
    n, d = codes.shape
    masked = torch.zeros(n, dtype=torch.bool, device=dev)
    lines = []
    for case, Xq in (("serve batch", queries[:BATCH]), ("whole query set", queries)):
        m, k = Xq.shape[0], K_QUANT
        reps = 20 if m == BATCH else 5
        call = (lambda: topk_quant_cuda(Xq, codes, scales, sqn, k=k))
        rd, ri = topk_quant_ref(Xq, codes, scales, sqn, k=k)
        _build._STATE["lib"] = built_lib
        row = {
            "case": f"quantized brute {case} {m}x{n}x{d} K={k} euclidean",
            "splits": len(int8_plan(m, n, k, dev)),
            "ms": cuda_ms(call, reps),
            "no_survivor_ms": cuda_ms(lambda: topk_quant_cuda(Xq, codes, scales, sqn, k=k,
                                                              valid=masked), reps),
            "query_prep_ms": cuda_ms(lambda: quantize_queries(Xq, scales), reps),
            "variants": {},
        }
        order = list(VARIANTS)
        for name in order + order[::-1]:
            lib, scans = libs[name]
            _build._STATE["lib"] = lib
            od, oi = call()
            if not (torch.equal(od, rd) and torch.equal(oi, ri)):
                raise SystemExit(f"variant {name} ({case}) is not bit-identical")
            entry = row["variants"].setdefault(name, {"ms": [], **scans})
            entry["ms"].append(cuda_ms(call, reps))
        _build._STATE["lib"] = built_lib
        lines.append(row)
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.out:
        with open(args.out, "w") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
            f.write(smi + "\n")
    print(smi)
    print(json.dumps({"cases": lines}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
