"""Mean of the live index's ``rescore`` span (the exact re-score of the
frozen oversample's alive candidates, ``core/live._merge_frozen_delta``,
synchronised at its close while telemetry is on); None where the program
has no such span."""
from bench.harness.readers import span_mean


def read(run):
    value = span_mean(run, "rescore")
    return None if value is None else 1e3 * value
