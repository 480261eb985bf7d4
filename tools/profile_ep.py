#!/usr/bin/env python3
"""Where an expert-parallel MoE decode step's time goes on one CUDA card,
beside the one-device dispatch.

    python3 tools/profile_ep.py [--arch qwen3-moe-235b-a22b] [--batch 32]
        [--cache 32768] [--prompt 512] [--steps 8] [--mesh 2,4] [--out FILE]

Run from the root of the repo.  The model is ``chip_smoke._moe_model``'s
(published widths, phase 13's depth cut, random weights from ``--seed``),
bf16 activations, TF32 off.  A ``--prompt``-token prompt is prefilled into
a cache of ``--cache`` positions once; each decode run starts from a copy
of that cache.  It prints one JSON line each:

- ``steps``: p50 ms of ``--steps`` greedy ``make_decode_step`` calls
  (host clock, synchronised) without a mesh (the dispatch) and under
  ``lm_policy(cfg, make_test_mesh(--mesh), kind="decode")`` (the
  expert-parallel path), in turns: dispatch, EP, EP, dispatch;
- ``moe_layer``: the MoE layer alone on the step's (B, 1, d) tokens: the
  dispatch, ``moe_ffn_ep``, and ``moe_ffn_ep`` with every expert weight
  already bf16 (no cast a call), p50 ms each, synchronised;
- ``shard_map``: host ms of one ``shard_map`` call over the mesh with a
  function that does nothing, and with three collectives on a (1, d)
  operand (the EP chunk's two all-gathers and a psum);
- ``profile``: ``torch.profiler`` over 3 decode steps each way (after a
  window that takes the profiler's start-up): device time summed over
  kernels against the wall time (the idle share), and the 12 kernels with
  the most device time.

The line before the last is the card's name and power limit as
``nvidia-smi`` gives them; the last is one JSON object of every line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "src"))


def _p50(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cache", type=int, default=32768)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_ep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, lm_policy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.train.train_step import make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    lines = []

    def emit(name, row):
        row = {"what": name, **row}
        lines.append(row)
        print(json.dumps(row), flush=True)

    model = cs._moe_model(args.arch, args.seed)
    cfg = model.cfg
    B, T = args.batch, args.cache
    mesh = make_test_mesh(tuple(int(v) for v in args.mesh.split(",")), device=dev)
    dctx = lm_policy(cfg, mesh, kind="decode", batch=B)
    prompt = cs._lm_tokens(cfg, B, args.prompt, args.seed, dev)
    last, cache0 = make_prefill_step(cfg, max_len=T)(model, prompt)
    tok0 = tf.greedy(last)
    del last

    def decode_run(ctx):
        step = make_decode_step(cfg, ctx)
        cache = {k: {n: t.clone() for n, t in c.items()} for k, c in cache0.items()}
        tok, times = tok0, []
        for i in range(args.steps):
            t0 = time.perf_counter()
            tok, cache = step(model, cache, tok[:, None], args.prompt + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        del cache
        return statistics.median(times[1:]) * 1e3

    runs = {"dispatch": [], "ep": []}
    for name in ("dispatch", "ep", "ep", "dispatch"):
        runs[name].append(decode_run(dctx if name == "ep" else None))
    emit("steps", {"arch": args.arch, "batch": B, "cache": T, "mesh": mesh.shape,
                   "ep_mode": moe.ep_mode(cfg, mesh), "p50_ms": runs})

    layer = tf._layer(model["moe_blocks"], 0)["mlp"]
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((B, 1, cfg.d_model), generator=g, device=dev).to(cfg.act_dtype())
    with torch.inference_mode():
        half = {k: layer[k].to(cfg.act_dtype()) for k in ("wg", "wu", "wd")}
        probs = moe.router_probs(x, layer["router"], cfg)
        top_w, top_i = moe.topk_weights(probs, cfg)
        pr = probs.to(x.dtype)
        fns = {"dispatch": lambda: moe.moe_ffn_dispatch(x, top_w, top_i, layer, cfg),
               "ep": lambda: moe.moe_ffn_ep(x, pr, layer, cfg, mesh=mesh,
                                            batch_axes=dctx.batch_axes),
               "ep_bf16_weights": lambda: moe.moe_ffn_ep(x, pr, half, cfg, mesh=mesh,
                                                         batch_axes=dctx.batch_axes)}
        for fn in fns.values():
            fn()
        emit("moe_layer", {"tokens": B, "p50_ms": {k: _p50(fn, 10) for k, fn in fns.items()},
                           "reached_experts": int(torch.unique(top_i).numel())})
    del half

    spec = P(tuple(mesh.axis_names))
    ops = torch.zeros((mesh.size, cfg.d_model), device=dev)

    def three(xl):
        a = sharding.all_gather(xl, "data")
        sharding.all_gather(xl, "data")
        return sharding.psum(a[:1], ("model", "data"))

    empty = sharding.shard_map(lambda xl: xl, mesh=mesh, in_specs=(spec,), out_specs=spec)
    coll = sharding.shard_map(three, mesh=mesh, in_specs=(spec,), out_specs=spec)
    emit("shard_map", {"ranks": mesh.size, "empty_ms": _p50(lambda: empty(ops), 50),
                       "three_collectives_ms": _p50(lambda: coll(ops), 50)})

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device=dev).add_(1)  # the profiler's start-up, not timed
        torch.cuda.synchronize()
    for name, ctx in (("dispatch", None), ("ep", dctx)):
        step = make_decode_step(cfg, ctx)
        cache = {k: {n: t.clone() for n, t in c.items()} for k, c in cache0.items()}
        step(model, cache, tok0[:, None], args.prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tok = tok0
            for i in range(3):
                tok, cache = step(model, cache, tok[:, None], args.prompt + 1 + i)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
        emit("profile", {"path": name, "steps": 3, "wall_ms": wall, "device_busy_ms": busy,
                         "idle_share": 1 - busy / wall if wall else None,
                         "kernels": [{"name": e.key[:80], "calls": e.count,
                                      "device_ms": e.self_device_time_total / 1e3}
                                     for e in top]})
        del cache

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"lines": lines, "device": smi}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(json.dumps(r) for r in lines) + "\n" + smi + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
