"""Multi-pod dry-run — port of ``repro/launch/dryrun.py``: run every
(architecture x input shape) once on the production mesh, on meta tensors,
and derive the roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each cell writes experiments/dryrun_torch/<arch>__<shape>__<mesh>.json in
JAX's layout.  JAX lowers and compiles the cell and reads XLA's memory and
cost analyses and the optimized HLO; the port has no HLO, so ``run_cell``
runs the cell's step once on its abstract arguments (meta tensors) over
``launch/mesh.make_meta_mesh`` — ranks that hold shapes only, one of them
run and weighted by the rank count (``dist/sharding``) — under
``roofline.OpCounter`` and ``roofline.collecting()``.  The keys with no
counterpart (``xla_flops``, ``xla_bytes``, ``compile_s``) are null.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

#: what each number of a result is, beside it (``method``)
METHOD = {
    "memory": "argument and output bytes: each leaf's bytes over the product of its "
              "spec's axis sizes; temp: the global peak of the live bytes the step "
              "allocated (its outputs included), over the chips — an estimate, since the "
              "port has no GSPMD (act moves nothing) and holds every rank's work on one "
              "meta device; peak = argument + temp; alias 0 (the port donates nothing)",
    "cost": "flops (torch.utils.flop_counter's formulas) and bytes (every tensor each "
            "op reads and writes) counted over the whole program once, the Python loops "
            "unrolled; loop_aware_* are those over the chips (JAX's are XLA's per-device "
            "counts after SPMD partitioning); useful_flops_ratio = model_flops / counted",
    "collectives": "explicit: the shard_map psum / all_gather the step ran (and their "
                   "transposes where they carry gradients), JAX's parse_collectives "
                   "convention; gspmd_implied: from the spec trees, the FSDP weight "
                   "all-gathers (forward, and backward when training) and gradient "
                   "reduce-scatters per microbatch that GSPMD would insert; GSPMD's "
                   "activation collectives are not modelled",
    "roofline": "roofline_terms on the per-chip flops and bytes and the collectives' "
                "total, at the H100's peaks (bf16 for bf16 activations, else f32; HBM; "
                "NVLink, nominal): analytic, not a device measurement",
}


def _spec_bytes(t, spec, mesh) -> float:
    """A leaf's bytes on one device under ``spec`` (None: replicated)."""
    from repro_torch.dist.sharding import _names

    if not hasattr(t, "nbytes"):
        return 0.0
    parts = 1
    for entry in (spec or ()):
        for name in _names(entry):
            parts *= mesh.shape[name]
    return t.nbytes / parts


def _tree_bytes(tree, specs, mesh) -> float:
    """Per-device bytes of ``tree`` under the matching ``specs`` tree."""
    from repro_torch.train import tree as tree_lib

    leaves, spec = tree_lib.flatten(tree)
    if specs is None:
        return float(sum(_spec_bytes(t, None, mesh) for t in leaves))
    return float(sum(_spec_bytes(t, s, mesh) for t, s in
                     zip(leaves, tree_lib.flatten_up_to(spec, specs))))


def _gspmd_implied(built, mesh) -> dict:
    """The FSDP collectives GSPMD would insert for an LM cell: each weight
    sharded over the FSDP axis is all-gathered over it (down to its other
    shards) once a forward and, training, once a backward per microbatch,
    and its gradient reduce-scattered per microbatch."""
    import torch

    from repro_torch.dist.sharding import _names
    from repro_torch.models import params as plib
    from repro_torch.models.transformer import lm_decls

    out = {"all-gather": 0, "reduce-scatter": 0}
    if built.meta["family"] != "lm" or not built.dctx.opt("fsdp"):
        return out
    fsdp = {built.dctx.w_rules.get(n) for n in ("embed", "embed_tbl")} - {None}
    if not fsdp:
        return out
    train = built.step_name == "train_step"
    mb = built.meta.get("microbatches", 1)
    for _, p in plib.leaves(lm_decls(built.cfg)):
        names = [n for e in p.logical for n in _names(built.dctx.w_rules.get(e))]
        if not fsdp & set(names):
            continue
        nbytes = math.prod(p.shape) * getattr(torch, p.dtype).itemsize
        kept = math.prod(mesh.shape[n] for n in names if n not in fsdp)
        every = math.prod(mesh.shape[n] for n in names)
        out["all-gather"] += int(nbytes / kept * (2 if train else 1) * mb)
        if train:
            out["reduce-scatter"] += int(nbytes / every * mb)
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             out_dir: str = "experiments/dryrun_torch", overrides=None,
             tag: str = "", mesh_shape=None) -> dict:
    """Build the cell (``launch/cells``) on the production mesh of meta
    ranks (``mesh_shape``: another data x model shape, for tests), run its
    step once under the counters, and write the result JSON.

    Per-device numbers: JAX's ``cost_analysis`` is per device after SPMD
    partitioning; the port counts the global program once, so its
    per-device terms are counted / chips and ``useful_flops_ratio`` is
    model_flops / counted flops.  A MoE cell whose batch does not split
    over the mesh (so no expert-parallel path) raises, naming the cell: the
    one-device dispatch sizes its capacity from the expert loads it reads
    on the host, which meta tensors do not have."""
    import torch

    from repro_torch.dist import roofline
    from repro_torch.dist.sharding import P
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_meta_mesh
    from repro_torch.models import transformer

    mesh = make_meta_mesh(multi_pod=multi_pod, shape=mesh_shape)
    mesh_name = "x".join(str(s) for s in mesh.shape.values())
    t0 = time.time()
    kw = {}
    if overrides:
        ov = dict(overrides)
        if "mla_absorb" in ov:
            kw["mla_absorb"] = bool(ov.pop("mla_absorb"))
        if ov:
            kw["overrides"] = ov
    built = cells.build(arch, shape, mesh, **kw)
    t_lower = time.time() - t0
    cfg = built.cfg
    if getattr(cfg, "moe", False) and not transformer.moe_takes_ep(
            cfg, built.dctx, built.batch_per_call):
        raise ValueError(
            f"{arch} x {shape} x {mesh_name}: a batch of {built.batch_per_call} does not "
            f"split over the mesh's batch axes {built.dctx.batch_axes or '()'}, so its MoE "
            "layers take the one-device dispatch, whose capacity comes from expert loads "
            "read on the host; meta tensors hold none")
    t0 = time.time()
    with roofline.OpCounter() as counter, roofline.collecting() as explicit:
        outputs = built.step(*built.args)
    t_run = time.time() - t0

    chips = int(mesh.size)
    arg_b = sum(_tree_bytes(a, s, mesh) for a, s in zip(built.args, built.in_specs))
    if built.out_specs is None or isinstance(built.out_specs, P):
        out_b = _tree_bytes(outputs, built.out_specs, mesh)
    else:
        out_b = sum(_tree_bytes(o, s, mesh) for o, s in zip(outputs, built.out_specs))
    temp_b = counter.peak_bytes / chips
    implied = _gspmd_implied(built, mesh)
    coll = roofline.CollectiveStats()
    for kind, b in list(explicit.bytes_by_kind.items()) + list(implied.items()):
        if b:
            coll.bytes_by_kind[kind] = coll.bytes_by_kind.get(kind, 0) + b
            coll.total_bytes += b
    coll.count = explicit.count
    act = getattr(cfg, "dtype", "float32")
    terms = roofline.roofline_terms(
        {"flops": counter.flops / chips, "bytes accessed": counter.bytes / chips}, coll,
        chips=chips, model_flops=built.meta.get("model_flops"),
        kind="bf16" if act == "bfloat16" else "f32")
    del outputs
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_name,
        "step": built.step_name,
        "ok": True,
        "lower_s": round(t_lower, 1),
        "compile_s": None,
        "run_s": round(t_run, 1),
        "memory": {
            "argument_bytes_per_device": arg_b,
            "output_bytes_per_device": out_b,
            "temp_bytes_per_device": temp_b,
            "alias_bytes_per_device": 0,
            "peak_estimate_gib": round((arg_b + temp_b) / 2**30, 3),
        },
        "cost": {
            "xla_flops": None,
            "xla_bytes": None,
            "loop_aware_flops": counter.flops / chips,
            "loop_aware_bytes": counter.bytes / chips,
            "dot_ops": counter.dot_ops,
            "counted_flops": counter.flops,
            "counted_bytes": counter.bytes,
            "ops": counter.ops,
        },
        "collectives": {
            "total_bytes": coll.total_bytes,
            "by_kind": coll.bytes_by_kind,
            "loop_trips": coll.loop_trip_counts,
            "explicit": explicit.bytes_by_kind,
            "gspmd_implied": implied,
        },
        "roofline": terms,
        "meta": {k: v for k, v in built.meta.items() if k != "mesh"},
        "method": METHOD,
        "torch": torch.__version__,
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="cell override key=value (microbatches=8, "
                         "param_dtype=bfloat16, moe_impl=zero3, opt=adamw)")
    args = ap.parse_args(argv)

    from repro_torch.launch import cells as cells_lib

    todo = cells_lib.all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                overrides = {}
                if args.mla_absorb:
                    overrides["mla_absorb"] = True
                for kv in args.set:
                    key, val = kv.split("=", 1)
                    overrides[key] = int(val) if val.isdigit() else val
                overrides = overrides or None
                r = run_cell(arch, shape, multi_pod=mp, out_dir=args.out_dir,
                             overrides=overrides, tag=args.tag)
                rf = r["roofline"]
                print(
                    f"OK  {label}: run={r['run_s']}s "
                    f"mem/dev={r['memory']['peak_estimate_gib']}GiB "
                    f"t_comp={rf['t_compute_s']:.2e}s t_mem={rf['t_memory_s']:.2e}s "
                    f"t_coll={rf['t_collective_s']:.2e}s dom={rf['dominant']}",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — sweep must survive
                failures.append((label, repr(e)))
                print(f"FAIL {label}: {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {[f[0] for f in failures]}")


if __name__ == "__main__":
    main()
