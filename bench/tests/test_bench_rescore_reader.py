"""The ``rescore_ms.live`` reader on canned telemetry."""
import types

import numpy as np
import pytest

from bench.harness import spec


def _run(**kw):
    base = dict(setup_s=21.5, build_s=12.25, stage_seconds={}, window=None, profile=None,
                telemetry=None, judge={}, comparisons=np.zeros((0,), np.int64), shapes={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(run):
    return spec.reader("rescore_ms.live")(run)


def test_rescore_reader():
    tel = {"spans": {"rescore": [1.7, 100], "dispatch": [2.0, 100]}, "walls": [0.021] * 100,
           "batches": 100}
    assert read(_run(telemetry=tel)) == pytest.approx(17.0)
    assert read(_run()) is None
    # a program without the span (the parent of the re-score kernel) reads nothing
    assert read(_run(telemetry=dict(tel, spans={"dispatch": [2.0, 100]}))) is None
