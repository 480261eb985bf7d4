"""The beam's final gathered bucket scan and merge per batch: the mean of
the program's ``bucket_scan`` span with ``mode="beam"``
(``core/vptree.search_beam``, synchronised at its close while telemetry is
on) in the telemetry half."""
from bench.harness.stages import span_ms


def read(run):
    return span_ms(run, "bucket_scan", mode="beam")
