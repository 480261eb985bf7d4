"""Small helpers the metric readers share."""
from __future__ import annotations


def span_mean(run, stage: str):
    """Mean seconds of the program's span ``stage`` in the telemetry half,
    or None without one."""
    tel = run.telemetry
    if not tel or stage not in tel["spans"] or tel["spans"][stage][1] == 0:
        return None
    total, count = tel["spans"][stage]
    return total / count


def span_total(run, stage: str) -> float:
    tel = run.telemetry
    return tel["spans"].get(stage, [0.0, 0])[0] if tel else 0.0


def closed_qps(run):
    """Queries answered in the closed-loop window over its seconds."""
    win = run.window
    if win is None or "batches" not in win or win["seconds"] <= 0:
        return None
    return (win["attempted"] - win["failed"]) / win["seconds"]


def server_host_ms(run):
    """A ``query`` call's mean wall time (host clock, the benchmark's) less
    the mean of its ``dispatch`` span (the program's, synchronised):
    padding, the copy to the card, the result back."""
    tel = run.telemetry
    dispatch = span_mean(run, "dispatch")
    if not tel or not tel.get("walls") or dispatch is None:
        return None
    return 1e3 * (sum(tel["walls"]) / len(tel["walls"]) - dispatch)


def idle_pct(run):
    """Share of the profiled window in which no device operation ran."""
    prof = run.profile
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
