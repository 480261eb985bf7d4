"""Reading the device's side of a window from ``torch.profiler``'s trace.

The profiled window is the span of the ``bench.window`` annotation.  From
the trace's device events (kernels, copies, sets) it takes the busy time
(their union within the window), the device time of each kernel by name,
and the idle gaps, each named by what the host was doing at the gap's
middle: the innermost host operation open then (an ATen op, a CUDA
runtime call or the benchmark's own annotation)."""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, template arguments and
    parameter list, cut to ``limit`` characters."""
    name = re.sub(r"^void\s+", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:limit]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(starts, host, t: float) -> str:
    """The host event open at time t that started last (the innermost)."""
    j = bisect.bisect_right(starts, t) - 1
    for _ in range(400):
        if j < 0:
            break
        a, b, name = host[j]
        if b >= t:
            return name
        j -= 1
    return "host (no traced op)"


def read(events: list[dict]) -> dict:
    """``events``: the trace's ``traceEvents``.  Returns ``window_s``,
    ``busy_s``, ``kernels`` {short name: device seconds}, ``kernels_full``
    {name: device seconds}, ``gaps`` {host activity: idle seconds}; None
    when the trace holds no window or no device event."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host = [], []
    kernels_full: dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                if cat == "kernel":
                    kernels_full[e["name"]] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((a, b, e["name"]))
    if not dev:
        return None
    busy = _union(dev)
    host.sort()
    starts = [h[0] for h in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_innermost(starts, host, 0.5 * (a + b))] += (b - a) * 1e-6
    kernels: dict[str, float] = defaultdict(float)
    for name, sec in kernels_full.items():
        kernels[short_name(name)] += sec
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": dict(kernels), "kernels_full": dict(kernels_full),
            "gaps": dict(gaps)}


def read_file(path) -> dict:
    with open(path) as fh:
        return read(json.load(fh).get("traceEvents", []))


def top(table: dict, n: int = 10) -> list:
    return [[name, sec] for name, sec in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
