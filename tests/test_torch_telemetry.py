"""Port parity: ``core/telemetry`` — the port's copy against the JAX
package's, on the CPU.

The same sequence of ``count`` / ``set_gauge`` / ``observe`` / ``span``
calls goes into both registries; ``metrics_text()`` and ``summary()`` must
be identical once the span timings are masked (histogram values the
caller gives are exact).  A span whose body raises still closes, flagged
``error=True``; the disabled path records nothing; the latency ring stays
bounded."""
import contextlib
import json
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import telemetry as jtelem  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import telemetry as ttelem  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

BOTH = (jtelem, ttelem)


@pytest.fixture(autouse=True)
def fresh_registries():
    for t in BOTH:
        t.reset()
        t.enable()
    yield
    for t in BOTH:
        t.reset()
        t.disable()


def _counters(t):
    t.count("queries_total", 64, engine="infinity")
    t.count("queries_total", 7, engine="brute")
    t.count("comparisons_total", 1234, engine="infinity", stage="traversal",
            q=t.q_label(float("inf")))
    t.count("comparisons_total", 96 * 64, engine="infinity", stage="rerank",
            q=t.q_label(2.0))
    t.count("jit_cache_misses_total", engine="nsw", scope="server", bucket=8)


def _gauges(t):
    t.set_gauge("recall_estimate", 0.8125, engine="brute", q="na", k=10)
    t.set_gauge("recall_estimate", 0.75, engine="brute", q="na", k=10)
    t.set_gauge("deadline_slack_frac", 0.5, engine="ivf_flat")


def _histograms(t):
    for v in (1e-5, 2e-4, 3e-3, 0.07, 2.0, 11.0):
        t.observe("search_latency", v, engine="infinity", shards=1)
    t.observe("probe_seconds", 0.01, engine="brute")


def _spans(t):
    for stage in ("pad", "dispatch", "dispatch"):
        with t.span(stage, engine="brute", bucket=8):
            pass
    with t.span("bucket_scan", engine="infinity", mode="beam"):
        pass


def _everything(t):
    _counters(t)
    _gauges(t)
    _histograms(t)
    _spans(t)


SEQUENCES = {"counters": _counters, "gauges": _gauges, "histograms": _histograms,
             "spans": _spans, "everything": _everything}

_STAGE_LINE = re.compile(r"^stage_seconds_(bucket|sum)")


def _masked_text(t) -> str:
    """metrics_text() with the span timings (stage_seconds buckets and
    sums) removed; their counts stay."""
    return "\n".join(line for line in t.metrics_text().splitlines()
                     if not _STAGE_LINE.match(line))


def _masked_summary(t) -> dict:
    out = t.summary()
    for rec in out["histograms"].get("stage_seconds", {}).values():
        rec["sum"] = rec["mean"] = "masked"
    return out


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_metrics_text_matches_jax(name):
    for t in BOTH:
        SEQUENCES[name](t)
    assert _masked_text(ttelem) == _masked_text(jtelem)
    assert _masked_text(ttelem)  # something was recorded


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_summary_matches_jax(name):
    for t in BOTH:
        SEQUENCES[name](t)
    assert _masked_summary(ttelem) == _masked_summary(jtelem)


@pytest.mark.parametrize("t", BOTH, ids=["jax", "port"])
def test_span_closes_with_error_when_its_body_raises(t):
    with pytest.raises(RuntimeError):
        with t.span("dispatch", engine="brute", bucket=8):
            raise RuntimeError("injected")
    ev = t.trace_events()[-1]
    assert ev["name"] == "dispatch" and ev["args"]["error"] is True
    (labels, rec), = t.histogram_series("stage_seconds")
    assert labels["stage"] == "dispatch" and rec["count"] == 1


def test_span_error_events_match_jax():
    for t in BOTH:
        with pytest.raises(ValueError):
            with t.span("snapshot", op="verify"):
                raise ValueError("corrupt")
    strip = [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid", "tid")}
             for ev in (jtelem.trace_events()[-1], ttelem.trace_events()[-1])]
    assert strip[0] == strip[1]


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_disabled_path_records_nothing(name):
    ttelem.disable()
    SEQUENCES[name](ttelem)
    snap = ttelem.snapshot()
    assert not snap["counters"] and not snap["gauges"] and not snap["histograms"]
    assert ttelem.trace_events() == []
    assert ttelem.span("x") is ttelem.span("y")  # the shared null span


@pytest.mark.parametrize("q", [float("inf"), 2.0, 8, 1.5, "na"])
def test_q_label_matches_jax(q):
    assert ttelem.q_label(q) == jtelem.q_label(q)


def test_trace_ring_cap_and_dump(tmp_path):
    for t in BOTH:
        t.set_trace_cap(4)
        for i in range(10):
            with t.span(f"s{i}", engine="e"):
                pass
    try:
        assert [e["name"] for e in ttelem.trace_events()] == \
               [e["name"] for e in jtelem.trace_events()]
        path = ttelem.dump_trace(str(tmp_path / "trace.json"))
        doc = json.loads(open(path).read())
        jdoc = json.loads(open(jtelem.dump_trace(str(tmp_path / "j.json"))).read())
        assert set(doc) == set(jdoc)
    finally:
        for t in BOTH:
            t.set_trace_cap(8192)  # the ring's default


@pytest.mark.parametrize("on,raises,synced", [
    (True, False, ["cpu"]),   # telemetry on: one sync, at the close
    (False, False, []),       # telemetry off: none
    (True, True, []),         # the body raised: none, the span still closes
], ids=["on", "off", "raised"])
def test_span_syncs_its_device_at_close_only_while_on(monkeypatch, on, raises, synced):
    """``span(sync=dev)`` synchronises ``dev`` once, after its body and
    before the clock is read, only while telemetry is on and only when the
    body raised nothing; the label set is the span's other keywords."""
    calls = []
    monkeypatch.setattr(ttelem, "sync", lambda dev: calls.append(str(dev)))
    ttelem.enable(on)
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with ttelem.span("rerank", engine="infinity", sync="cpu"):
            assert calls == []
            if raises:
                raise RuntimeError("boom")
    assert calls == synced
    with ttelem.span("rerank", engine="infinity"):
        pass
    assert calls == synced  # no ``sync=``: never synchronises
    events = ttelem.trace_events()
    assert len(events) == (2 if on else 0)
    assert all("sync" not in e["args"] for e in events)
    assert [lbl for lbl, _ in ttelem.histogram_series("stage_seconds")] == (
        [{"stage": "rerank", "engine": "infinity"}] if on else [])


def test_latency_ring_is_bounded_like_jax():
    rings = (jserve.LatencyRing(cap=64), tserve.LatencyRing(cap=64))
    rng = np.random.default_rng(0)
    for lat, nq in zip(rng.uniform(size=1000), rng.integers(1, 512, size=1000)):
        for r in rings:
            r.append(float(lat), int(nq))
    (jl, jn), (tl, tn) = (r.window() for r in rings)
    assert len(rings[1]) == len(rings[0]) == 64
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("enabled", [False, True])
def test_disabled_telemetry_adds_no_device_sync(monkeypatch, enabled):
    """Every device sync that feeds a counter or a span sits behind
    ``telemetry.enabled()``: a disabled beam / best-first search and a live
    delta search make none (a served batch's one sync is the server's).
    Spans synchronise in ``core/telemetry`` (``span(sync=)``)."""
    from repro_torch.core import index as tindex
    from repro_torch.core import search as tsearch

    calls = []
    for mod in (ttelem, tsearch):
        monkeypatch.setattr(mod, "sync", lambda dev: calls.append(dev))
    ttelem.enable(enabled)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    idx = tindex.build("infinity", X, {"proj_sample": 64, "knn_k": 4, "num_hops": 2,
                                       "embed_dim": 4, "hidden": (8,), "train_steps": 5,
                                       "batch_pairs": 32, "rerank": 16}, device="cpu")
    live = tindex.build("live", X, {"engine": "brute", "delta_cap": 8}, device="cpu")
    live.upsert(X[:3] + 0.5)
    calls.clear()
    for batch in (64, 8):
        idx.search(X[:batch], k=5)
    live.search(X[:8], k=5)
    assert (len(calls) > 0) == enabled


# ---------------------------------------------------------------------------
# the spans on torch.profiler's clock (the port's own; no JAX counterpart)
# ---------------------------------------------------------------------------

BEAM_CFG = {"proj_sample": 64, "knn_k": 4, "num_hops": 2, "embed_dim": 4, "hidden": (8,),
            "train_steps": 5, "batch_pairs": 32, "rerank": 16}
#: the ranges a served batch of 64 leaves, by their parent range (None: top)
SERVED_RANGES = {"pad": None, "dispatch": None, "embed": "dispatch",
                 "traversal": "dispatch", "bucket_scan": "dispatch", "rerank": "dispatch"}


@pytest.fixture(scope="module")
def beam_server():
    """An infinity server whose batches of 64 take the beam."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    return tserve.SearchServer(X, engine="infinity", cfg=BEAM_CFG, device="cpu"), X[:64] + 0.01


def _profiled_ranges(fn, tmp_path):
    """Run ``fn`` under ``torch.profiler`` (CPU); returns (fn's result,
    [(stage, start, end)] of the ``repro_torch.*`` ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    assert not torch._C._autograd._profiler_enabled()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cut = len(ttelem.RANGE_PREFIX)
    ranges = [(e["name"][cut:], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(ttelem.RANGE_PREFIX)]
    return res, ranges


def test_span_with_telemetry_and_profiler_off_is_the_null_span(monkeypatch):
    import torch

    calls = []
    enter = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: calls.append(a[0]) or enter(*a))
    ttelem.disable()
    assert ttelem.span("dispatch", engine="brute") is ttelem.span("pad")
    with ttelem.span("dispatch", engine="brute"):
        pass
    assert calls == []
    # the same call under the profiler opens the range: the patch counts it
    from torch.profiler import profile

    with profile():
        with ttelem.span("dispatch", engine="brute"):
            pass
    assert calls == ["repro_torch.dispatch"]


def test_served_batch_leaves_nested_ranges_and_no_sync(beam_server, monkeypatch, tmp_path):
    """Telemetry off, under the profiler: one range per span of a served
    batch of 64 (the beam), nested as the program opens them; no span
    synchronises (the server's own sync of its answer is not a span's)."""
    from repro_torch.core import search as tsearch

    srv, Q = beam_server
    calls = []
    for mod in (ttelem, tsearch):
        monkeypatch.setattr(mod, "sync", lambda dev: calls.append(dev))
    ttelem.disable()
    _, ranges = _profiled_ranges(lambda: srv.query(Q, k=5), tmp_path)
    assert calls == []
    assert sorted(name for name, _, _ in ranges) == sorted(SERVED_RANGES)
    spans = {name: (a, b) for name, a, b in ranges}
    for name, parent in SERVED_RANGES.items():
        a, b = spans[name]
        holders = [p for p, (pa, pb) in spans.items() if p != name and pa <= a and b <= pb]
        assert holders == ([] if parent is None else [parent]), name
    order = sorted(SERVED_RANGES, key=lambda n: spans[n][0])
    assert order == ["pad", "dispatch", "embed", "traversal", "bucket_scan", "rerank"]
    assert ttelem.trace_events() == []  # the ranges alone: nothing recorded


def test_telemetry_measures_the_beam_stages(beam_server):
    srv, Q = beam_server
    srv.query(Q, k=5)
    series = {lbl["stage"]: (lbl, rec) for lbl, rec in ttelem.histogram_series("stage_seconds")}
    for stage in ("traversal", "bucket_scan"):
        lbl, rec = series[stage]
        assert lbl["mode"] == "beam" and rec["count"] == 1 and rec["sum"] > 0
    assert "centroid_rank" not in series  # counted, not timed
    assert ttelem.counter_total("comparisons_total", stage="centroid_rank") > 0
    assert all("estimated" not in ev["args"] for ev in ttelem.trace_events())


def test_answers_identical_with_telemetry_and_profiler_on_or_off(beam_server, tmp_path):
    srv, Q = beam_server
    got = {}
    for tel in (False, True):
        for prof in (False, True):
            ttelem.enable(tel)
            if prof:
                res, ranges = _profiled_ranges(lambda: srv.query(Q, k=5), tmp_path)
                assert ranges
            else:
                res = srv.query(Q, k=5)
            got[tel, prof] = res
    ref = got[False, False]
    for res in got.values():
        np.testing.assert_array_equal(res.idx, ref.idx)
        np.testing.assert_array_equal(res.dist, ref.dist)
        np.testing.assert_array_equal(res.comparisons, ref.comparisons)
