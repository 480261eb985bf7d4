"""Queries answered a second in the telemetry half of a traced run of the
q = infinity b512 cell: its answered queries over the summed wall time of
its ``query`` calls.  The program's spans synchronise in that half, so
this reads below the end-to-end ``qps`` of an untraced run; it follows
the cell's throughput where ``qps`` is not held to a bound."""


def read(run):
    tel = run.telemetry
    if not tel or not tel.get("walls") or "attempted" not in tel:
        return None
    seconds = float(sum(tel["walls"]))
    if seconds <= 0:
        return None
    return (tel["attempted"] - tel["failed"]) / seconds
