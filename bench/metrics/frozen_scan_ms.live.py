"""Mean of the live index's ``frozen_scan`` span (the frozen segment's
oversampled search, synchronised while telemetry is on)."""
from bench.harness.readers import span_mean


def read(run):
    value = span_mean(run, "frozen_scan")
    return None if value is None else 1e3 * value
