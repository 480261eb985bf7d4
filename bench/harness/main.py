"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics, the result line.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

A ``--trace 0`` run measures the cell's end-to-end metrics over one window.
A ``--trace 1`` run splits its window: the first half under
``torch.profiler`` with the program's telemetry off (device busy and idle,
kernel time by name, the breakdown), the second half with
``core/telemetry`` on (the program's synchronised spans and its exact
counters), and prints the cell's per-layer metrics.  Both judge every
answer of the window against the reference once the window has closed and
the program's state is freed.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench.harness import drive, judge as judge_lib, spec as spec_lib
from bench.harness import trace as trace_lib, traffic as traffic_lib
from bench.harness.system import Data, System, sync

OUT = spec_lib.BENCH / "out"
#: top-level modules the process may not hold when it reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What a run saw, for the metric readers (``bench/metrics``)."""

    def __init__(self, cell):
        self.config, self.traffic = cell.config, cell.traffic
        self.setup_s = self.build_s = None
        self.stage_seconds: dict = {}
        self.window = None  # the --trace 0 window
        self.profile = None  # the profiled half: trace_lib.read + batches
        self.telemetry = None  # the telemetry half: spans, walls, counters
        self.judge: dict = {}
        self.comparisons = np.zeros((0,), np.int64)
        self.shapes: dict = {}


def device_line(device: torch.device) -> str:
    if device.type != "cuda":
        return f"device: cpu; torch {torch.__version__}"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = [f"nvidia-smi unavailable ({exc!r})"]
    return (f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: "
            f"{smi[device.index or 0] if smi else '?'}; torch {torch.__version__}; "
            f"CUDA {torch.version.cuda}")


def _spans() -> dict:
    """stage -> [seconds summed, count] over every label set."""
    from repro_torch.core import telemetry as telem

    out: dict = {}
    for labels, rec in telem.histogram_series("stage_seconds"):
        acc = out.setdefault(labels.get("stage", "?"), [0.0, 0])
        acc[0] += rec["sum"]
        acc[1] += rec["count"]
    return out


def _activities(device: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def _profiled(fn, path: Path, device: torch.device):
    """Run ``fn`` under ``torch.profiler`` inside the ``bench.window``
    annotation; returns (fn's result, the trace read by ``trace_lib``)."""
    from torch.profiler import profile, record_function

    with profile(activities=_activities(device)) as prof:
        with record_function(trace_lib.WINDOW):
            res = fn()
            sync(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return res, trace_lib.read_file(path)


def _warm_profiler(device: torch.device) -> None:
    """The profiler's own start-up, paid in set-up and not in the window."""
    from torch.profiler import profile

    with profile(activities=_activities(device)):
        torch.ones(8, device=device).add_(1)
        sync(device)


def _telemetry_half(fn):
    from repro_torch.core import telemetry as telem

    telem.reset()
    telem.enable()
    try:
        res = fn()
    finally:
        spans = _spans()
        telem.disable()
    return res, spans


def execute(cell, *, seed: int, seconds: float, trace: bool, device: torch.device,
            t_start: float, log=print) -> tuple[dict, Run]:
    """Run ``cell`` once; returns (the result line's object, the Run)."""
    cfg, tr = cell.config, cell.traffic
    run = Run(cell)
    k = int(tr["k"])
    data = Data(cfg, seed, device)
    system = System(cfg, tr, data, seed, device)
    run.build_s, run.stage_seconds = system.build_s, system.stage_seconds
    system.warm_up(tr, data.queries_host)
    if trace:
        _warm_profiler(device)
    bucket = system.bucket(tr)
    run.shapes = {"batch": bucket, "dim": int(data.corpus.shape[1]), "k": k,
                  "rows_alive": int(system.alive.sum())}
    sync(device)
    run.setup_s = time.perf_counter() - t_start
    trace_path = OUT / f"{cell.name}.trace.json"

    answers = drive.Answers()
    order = traffic_lib.query_order(data.n_test, seed)
    batch = int(tr["batch"])

    def window(secs, first=0, mark=None):
        return drive.closed_window(system.server, data.queries_host, order, batch=batch,
                                   k=k, seconds=secs, first=first, mark=mark)

    if not trace:
        run.window = win = window(seconds)
        parts = [win]
        walls = np.asarray(win["walls"])
        quarters = [f"{batch * q.size / q.sum():.1f}" for q in np.array_split(walls, 4) if q.size]
        log(f"closed loop: {win['batches']} batches of {batch}; queries/s by quarter of "
            f"the window: {', '.join(quarters)}")
    else:
        from torch.profiler import record_function

        w1, prof = _profiled(lambda: window(seconds / 2, mark=record_function),
                             trace_path, device)
        if prof is not None:
            prof["batches"] = w1["batches"]
        run.profile = prof
        w2, spans = _telemetry_half(lambda: window(seconds / 2, first=w1["next"]))
        run.telemetry = {"spans": spans, "walls": w2["walls"], "batches": w2["batches"],
                         "attempted": w2["attempted"], "failed": w2["failed"]}
        parts = [w1, w2]
    for p in parts:
        answers.extend(p["answers"])

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    system.close()
    qids_all, idx, dist, comps = answers.arrays(k)
    run.comparisons = comps
    run.judge = judge_lib.judge(data.queries, system.rows, system.alive, qids_all, idx, dist,
                                k=k, exact=bool(cfg.get("exact", False)))
    missing = sum(p["missing"] for p in parts)
    correct, checks = judge_lib.verdict(run.judge, cfg.get("limits", {}), missing)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_lib.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(sum(p["attempted"] for p in parts)),
              "failed": int(sum(p["failed"] for p in parts)),
              "metrics": metrics, "device": dev_info}
    if trace and run.profile is not None:
        dev_info["busy_s"] = run.profile["busy_s"]
        dev_info["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": trace_lib.top(run.profile["kernels"]),
                               "idle_gaps": trace_lib.top(run.profile["gaps"])}
    result["checks"] = checks
    return result, run


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec_lib.Cell(spec_lib.load_spec(), args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: this cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
              "no result without the card", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"error: the program (src/repro_torch) is not here: {exc}", file=sys.stderr)
        return 5
    device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    print(device_line(device), flush=True)
    result, _ = execute(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                        device=device, t_start=t_start,
                        log=lambda s: print(s, flush=True))
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        print(f"error: the process holds {held} after the window: the JAX package "
              "or JAX was loaded; no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

