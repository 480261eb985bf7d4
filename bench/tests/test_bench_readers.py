"""Each metric reader on a canned trace and canned counters, and the
trace reader on canned profiler events."""
import math
import types

import numpy as np
import pytest

from bench.harness import spec, trace
from bench.roofline.h100 import F32_FLOPS


def _run(**kw):
    base = dict(setup_s=21.5, build_s=12.25, stage_seconds={"train_phi": 8.5},
                window=None, profile=None, telemetry=None, judge={},
                comparisons=np.zeros((0,), np.int64), shapes={})
    base.update(kw)
    return types.SimpleNamespace(**base)


def read(name, run):
    return spec.reader(name)(run)


def test_end_to_end_readers():
    closed = {"seconds": 10.0, "attempted": 100_000, "failed": 1_000, "batches": 200}
    assert read("qps", _run(window=closed)) == pytest.approx(9_900.0)
    assert read("qps.live", _run(window=closed)) == pytest.approx(9_900.0)
    assert read("recall_at_10", _run(judge={"recall": 0.25})) == 0.25
    assert read("build_s", _run()) == 12.25
    assert read("setup_s", _run()) == 21.5
    # a window that timed nothing gives no rate
    assert read("qps", _run(window=dict(closed, seconds=0.0))) is None


def test_span_and_counter_readers():
    tel = {"spans": {"dispatch": [2.0, 100], "embed": [0.2, 100], "rerank": [0.3, 100],
                     "frozen_scan": [5.0, 100]},
           "walls": [0.021] * 100, "batches": 100, "attempted": 51_200, "failed": 200}
    run = _run(telemetry=tel, comparisons=np.array([1000, 1200]))
    assert read("traversal_ms.b512", run) == pytest.approx(15.0)
    assert read("server_host_ms.b512", run) == pytest.approx(1.0)
    assert read("server_host_ms.live", run) == pytest.approx(1.0)
    assert read("frozen_scan_ms.live", run) == pytest.approx(50.0)
    assert read("comparisons_per_query.b512", run) == pytest.approx(1100.0)
    # answered queries over the calls' summed walls: 51 000 / 2.1 s
    assert read("qps_telemetry.b512", run) == pytest.approx(51_000 / 2.1)
    assert read("phi_train_s", run) == 8.5
    # nothing to read: no value, never 0
    empty = _run()
    for name in ("traversal_ms.b512", "server_host_ms.b512", "server_host_ms.live",
                 "frozen_scan_ms.live", "comparisons_per_query.b512", "topk_roofline",
                 "device_idle_pct.b512", "device_idle_pct.live", "qps", "qps.live",
                 "qps_telemetry.b512"):
        assert read(name, empty) is None, name


def test_device_trace_readers():
    shapes = {"batch": 512, "rows_alive": 60_000, "dim": 784, "k": 10}
    bound = 2 * 512 * 60_000 * 784 / F32_FLOPS
    prof = {"window_s": 2.0, "busy_s": 1.5, "batches": 20,
            "kernels": {"(anonymous namespace)::topk_kernel": 20 * bound * 40,
                        "::sqnorm_kernel": 20 * bound * 5, "::merge_kernel": 20 * bound * 5,
                        "at::native::reduce_kernel": 1.0}}
    run = _run(profile=prof, shapes=shapes)
    assert read("topk_roofline", run) == pytest.approx(2.0)
    assert read("device_idle_pct.b512", run) == pytest.approx(25.0)
    assert read("device_idle_pct.live", run) == pytest.approx(25.0)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_busy_kernels_and_idle_gaps():
    events = [
        _ev(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _ev("void topk_kernel<0, 10>(float const*, int)", "kernel", 1100.0, 200.0),
        _ev("void at::native::reduce_kernel<512, 1>(float)", "kernel", 1250.0, 100.0),
        _ev("Memcpy HtoD", "gpu_memcpy", 1600.0, 100.0),
        _ev("void topk_kernel<0, 64>(float const*, int)", "kernel", 1900.0, 200.0),
        _ev("aten::sort", "cpu_op", 1400.0, 150.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 1450.0, 20.0),
        _ev("aten::item", "cpu_op", 1720.0, 170.0),
    ]
    got = trace.read(events)
    # busy: [1100, 1350] + [1600, 1700] + [1900, 2000] (clipped to the window)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx(450e-6)
    assert got["kernels"]["topk_kernel"] == pytest.approx(300e-6)
    assert got["kernels"]["at::native::reduce_kernel"] == pytest.approx(100e-6)
    # gaps: [1000,1100] no op, [1350,1600] mid 1475 inside aten::sort (the launch
    # inside it has ended),
    # [1700,1900] mid 1800 inside aten::item
    assert got["gaps"]["host (no traced op)"] == pytest.approx(100e-6)
    assert got["gaps"]["aten::sort"] == pytest.approx(250e-6)
    assert got["gaps"]["aten::item"] == pytest.approx(200e-6)
    assert trace.top(got["gaps"], 1) == [["aten::sort", pytest.approx(250e-6)]]
    assert trace.read([e for e in events if e["cat"] != "kernel" and e["cat"] != "gpu_memcpy"]) is None
    assert math.isclose(sum(got["gaps"].values()) + got["busy_s"], got["window_s"])


def test_kernel_short_names():
    assert trace.short_name("void (anonymous namespace)::topk_kernel<0, 64, true>(float const*)") \
        == "::topk_kernel"
    assert trace.short_name("sm80_xmma_gemm_f32f32") == "sm80_xmma_gemm_f32f32"
