"""The beam's traversal per batch: the server's ``dispatch`` span less the
``embed`` and ``rerank`` spans inside it (all synchronised while the
program's telemetry is on), per batch of the telemetry half."""
from bench.harness.readers import span_total


def read(run):
    tel = run.telemetry
    if not tel or tel["batches"] == 0 or "dispatch" not in tel["spans"]:
        return None
    rest = span_total(run, "dispatch") - span_total(run, "embed") - span_total(run, "rerank")
    return 1e3 * rest / tel["batches"]
