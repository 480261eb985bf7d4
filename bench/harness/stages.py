"""The program's stages on the device's clock.

While ``torch.profiler`` collects, each of the program's telemetry spans
is a profiler range named ``repro_torch.<stage>`` (``core/telemetry``),
recorded on the clock of the trace's ATen ops, CUDA runtime calls and
kernels.  This module reads the trace of a traced run's profiled half
(``bench/out/<cell>.trace.json``), cuts the profiled window into pieces,
each owned by the innermost range open on the host then (or by none), and
gives each stage its wall time, the time within it in which the card ran
a kernel, copy or set (busy) or nothing (idle), the kernel launches the
host made in it, and the device time of the work those calls launched
(launched), matched call to kernel by the profiler's correlation id, so
that a kernel that runs after its stage has closed still counts to it.
Telemetry is off in that half, so no span synchronises and the card runs
as it does untraced.

    python3 -m bench.harness.stages bench/out/<cell>.trace.json

prints the per-stage table, per batch (per ``repro_torch.dispatch``
range).  A trace of a program without the ranges reads as None."""
from __future__ import annotations

import bisect
import functools
import json
import sys
from pathlib import Path

from bench.harness import spec as spec_lib
from bench.harness.trace import DEVICE_CATS, WINDOW, _union

PREFIX = "repro_torch."
#: the CUDA API calls (`cuda*` and `cu*`) that launch work on the card
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaGraphLaunch"})
NO_RANGE = "(no range)"


def _pieces(w0: float, w1: float, ranges: list) -> list:
    """[w0, w1] cut into (start, end, stage) pieces, each named by the
    innermost range open there (``NO_RANGE`` outside every range)."""
    pieces, stack, t = [], [], w0

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            pieces.append((t, end, name))
            t = max(t, end)

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(a)
        pieces.append((t, a, stack[-1][1] if stack else NO_RANGE))
        t = max(t, a)
        stack.append((b, name))
    close_until(float("inf"))
    pieces.append((t, w1, NO_RANGE))
    return [(a, b, name) for a, b, name in pieces if b > a]


def read(events: list) -> dict | None:
    """``events``: the trace's ``traceEvents``.  Returns ``window_s``,
    ``dispatches`` (the number of ``dispatch`` ranges), ``dispatch_launches``
    (launches that start inside one) and ``stages`` {stage: {``wall_s``,
    ``busy_s``, ``idle_s``, ``launches``, ``launched_s``}} over the
    innermost-range pieces, ``launched_s`` being the whole device time of
    the kernels, copies and sets whose correlation id a CUDA runtime call
    made in the stage carries; None when the trace holds no window or no
    ``repro_torch.*`` range."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ranges, dev, launches, calls = [], [], [], []
    work: dict = {}  # correlation id -> device seconds of what it launched
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith(PREFIX):
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ranges.append((a, b, name[len(PREFIX):]))
        elif cat in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                work[corr] = work.get(corr, 0.0) + (b - a) * 1e-6
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
        elif cat == "cuda_runtime" and w0 <= a < w1:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                calls.append((a, corr))
            if name in LAUNCHES:
                launches.append(a)
    if not ranges:
        return None
    pieces = _pieces(w0, w1, ranges)
    busy = _union(dev)
    stages: dict[str, dict] = {}
    j = 0
    for a, b, name in pieces:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        on = 0.0
        i = j
        while i < len(busy) and busy[i][0] < b:
            on += min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
        rec = stages.setdefault(name, {"wall_s": 0.0, "busy_s": 0.0, "idle_s": 0.0,
                                       "launches": 0, "launched_s": 0.0})
        rec["wall_s"] += (b - a) * 1e-6
        rec["busy_s"] += on * 1e-6
        rec["idle_s"] += (b - a - on) * 1e-6
    starts = [p[0] for p in pieces]

    def owner(t):
        return stages[pieces[max(0, bisect.bisect_right(starts, t) - 1)][2]]

    for t, corr in calls:
        owner(t)["launched_s"] += work.get(corr, 0.0)
    dispatch = sorted((a, b) for a, b, name in ranges if name == "dispatch")
    d_starts = [a for a, _ in dispatch]
    in_dispatch = 0
    for t in launches:
        owner(t)["launches"] += 1
        k = bisect.bisect_right(d_starts, t) - 1
        in_dispatch += k >= 0 and t < dispatch[k][1]
    return {"window_s": (w1 - w0) * 1e-6, "dispatches": len(dispatch),
            "dispatch_launches": in_dispatch, "stages": stages}


@functools.lru_cache(maxsize=2)
def _read_file(path: str, mtime_ns: int) -> dict | None:
    with open(path) as fh:
        return read(json.load(fh).get("traceEvents", []))


def read_file(path) -> dict | None:
    """``read`` of a trace file, parsed once per process while the file
    stays as it is."""
    path = Path(path)
    if not path.is_file():
        return None
    return _read_file(str(path), path.stat().st_mtime_ns)


def cell_name(run) -> str | None:
    """The cell whose configuration and traffic mix the run ran, by
    ``BENCHMARK.json``; None when none matches (a run at another size)."""
    spec = spec_lib.load_spec()
    for w in spec["workloads"]:
        if w["config"] != run.config.get("name"):
            continue
        with open(spec_lib.BENCH / "traffic" / f"{w['traffic']}.json") as fh:
            if json.load(fh) == run.traffic:
                return w["name"]
    return None


def run_stages(run) -> dict | None:
    """``read`` of the trace that the run's profiled half wrote; None
    without a profiled half, a trace or the program's ranges."""
    if not run.profile:
        return None
    name = cell_name(run)
    if name is None:
        return None
    return read_file(spec_lib.BENCH / "out" / f"{name}.trace.json")


def span_ms(run, stage: str, **labels):
    """Mean milliseconds of the program's span ``stage`` whose labels hold
    ``labels``, in the telemetry half: its ``stage_seconds`` series, which
    the half leaves in the program's registry.  None without a telemetry
    half or such a span."""
    if not run.telemetry:
        return None
    from repro_torch.core import telemetry as telem

    total = count = 0
    for lbl, rec in telem.histogram_series("stage_seconds"):
        if lbl.get("stage") == stage and all(lbl.get(k) == v for k, v in labels.items()):
            total += rec["sum"]
            count += rec["count"]
    return 1e3 * total / count if count else None


def table(got: dict) -> str:
    """The per-stage table, per batch."""
    n = max(1, got["dispatches"])
    lines = [f"window {got['window_s']:.3f} s, {got['dispatches']} dispatch ranges; "
             f"{got['dispatch_launches'] / n:.1f} launches a batch inside dispatch",
             f"{'stage':<16}{'wall ms':>10}{'busy ms':>10}{'idle ms':>10}{'idle %':>8}"
             f"{'launches':>10}{'host us/launch':>16}{'launched ms':>13}"]
    for name, rec in sorted(got["stages"].items(), key=lambda kv: -kv[1]["wall_s"]):
        wall = rec["wall_s"]
        per_launch = f"{1e6 * wall / rec['launches']:.2f}" if rec["launches"] else "-"
        lines.append(f"{name:<16}{1e3 * wall / n:>10.3f}{1e3 * rec['busy_s'] / n:>10.3f}"
                     f"{1e3 * rec['idle_s'] / n:>10.3f}"
                     f"{100 * rec['idle_s'] / wall if wall else 0:>8.1f}"
                     f"{rec['launches'] / n:>10.1f}{per_launch:>16}"
                     f"{1e3 * rec['launched_s'] / n:>13.3f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python3 -m bench.harness.stages <trace.json>", file=sys.stderr)
        return 2
    got = read_file(args[0])
    if got is None:
        print(f"no window or no {PREFIX}* range in {args[0]}", file=sys.stderr)
        return 1
    print(table(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
