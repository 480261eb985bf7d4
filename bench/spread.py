"""The spread of sets of runs of a cell, and the bound it supports.

    python3 bench/spread.py SET_A.jsonl SET_B.jsonl

Each file is one set of runs of one cell: each line one run's result
object (the last line ``bench/run.py`` prints); other lines are passed
over.  For each metric the runs report it prints, set by set, the median
and the spread: the distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) over the median, over all the
runs, and leaving out the run farthest from the median where that narrows
it.  Then the bound that the widest set supports: ``FACTOR`` times its
spread so reckoned, rounded up to the next hundredth.  ``setup_s`` takes
its bound by its median alone, so no bound is given for it.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

#: a bound as a multiple of the widest set's spread without its farthest run
FACTOR = 2.5


def spread(values) -> float:
    """The quartiles' distance over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_spread(values) -> float:
    """``spread`` without the run farthest from the median, where that
    narrows it (a tie for farthest leaves out the first)."""
    values = list(values)
    whole = spread(values)
    if len(values) < 3:
        return whole
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return min(whole, spread(values[:far] + values[far + 1:]))


def bound(spread_: float) -> float:
    """``FACTOR`` times a spread, rounded up to the next hundredth
    (round-off of the product is not rounded up)."""
    return math.ceil(round(100.0 * FACTOR * spread_, 9)) / 100.0


def load(path) -> list[dict]:
    """The result objects of a set's file, in order."""
    runs = []
    with open(path) as fh:
        for line in fh:
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("metrics"), dict):
                runs.append(obj)
    return runs


def report(sets: list[list[dict]]) -> dict:
    """metric -> ``sets`` (each: ``n``, ``median``, ``spread``,
    ``trimmed``), ``widest`` (the widest set's spread of all its runs),
    ``widest_trimmed``, and, but for ``setup_s``, ``bound``."""
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    out = {}
    for name in names:
        per = []
        for runs in sets:
            vals = [float(r["metrics"][name]["value"]) for r in runs if name in r["metrics"]]
            if len(vals) < 2:
                continue
            per.append({"n": len(vals), "median": statistics.median(vals),
                        "spread": spread(vals), "trimmed": trimmed_spread(vals)})
        if not per:
            continue
        rec = {"sets": per, "widest": max(s["spread"] for s in per),
               "widest_trimmed": max(s["trimmed"] for s in per)}
        if name != "setup_s":
            rec["bound"] = bound(rec["widest_trimmed"])
        out[name] = rec
    return out


def text(rep: dict) -> str:
    lines = []
    for name, rec in rep.items():
        lines.append(name)
        for i, s in enumerate(rec["sets"]):
            lines.append(f"  set {i + 1}: n {s['n']}, median {s['median']!r}, spread "
                         f"{100 * s['spread']:.3f} %, without the farthest {100 * s['trimmed']:.3f} %")
        line = (f"  widest {100 * rec['widest']:.3f} % ({100 * rec['widest_trimmed']:.3f} % without "
                f"the farthest)")
        if "bound" in rec:
            line += f"; bound {rec['bound']:.2f}"
        lines.append(line)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sets", nargs="+", help="one file of result lines per set of runs")
    args = ap.parse_args(argv)
    sets = [load(p) for p in args.sets]
    if not all(sets):
        print("error: a set holds no result line", file=sys.stderr)
        return 1
    print(text(report(sets)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
