"""``harness/stages.py`` and the beam's readers: busy, idle, launches and
the device time of what was launched put down to the innermost
``repro_torch.*`` range of a hand-built trace, launches counted per
``dispatch``, nothing read where the run holds nothing; on the card, the
q = 2 b512 cell's traced run reports all four, and one level-loop launch a
``search_beam`` call."""
import json
import time
import types

import numpy as np
import pytest

from bench.harness import main, spec, stages, trace

B512 = "fmnist784-infinity-b512"
Q2_B512 = "fmnist784-q2-b512"  # the b512 cell that reports the beam metrics
BEAM_METRICS = ("beam_levels_ms.b512", "bucket_scan_ms.b512", "launches_per_batch.b512",
                "beam_device_ms.b512")


def _ev(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _rng(stage, ts, dur):
    return _ev(stages.PREFIX + stage, "user_annotation", ts, dur)


def _launch(ts, name="cudaLaunchKernel", corr=None):
    return _ev(name, "cuda_runtime", ts, 2.0, corr)


# one window [0, 1000] µs and two batches: pad, then dispatch ⊃ embed,
# traversal, bucket_scan
EVENTS = [
    _ev(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _rng("pad", 10.0, 20.0),
    _rng("dispatch", 40.0, 400.0),
    _rng("embed", 50.0, 50.0),
    _rng("traversal", 100.0, 300.0),
    _rng("bucket_scan", 400.0, 30.0),
    _rng("pad", 500.0, 20.0),
    _rng("dispatch", 530.0, 400.0),
    _rng("traversal", 600.0, 300.0),
    # device: [60, 80] under embed; [150, 200] and [380, 410] straddling
    # traversal | bucket_scan; a copy [20, 25] under pad; [950, 970] outside
    _ev("gemm", "kernel", 60.0, 20.0, corr=1),
    _ev("where", "kernel", 150.0, 30.0, corr=2),
    _ev("gather", "kernel", 170.0, 30.0, corr=3),  # overlaps the last: counted once
    _ev("sort", "kernel", 380.0, 30.0),
    _ev("Memcpy HtoD", "gpu_memcpy", 20.0, 5.0),
    _ev("cat", "kernel", 950.0, 20.0, corr=4),
    _ev("aten::where", "cpu_op", 140.0, 20.0),  # a host op names no stage
    # launched: gemm by embed's call, where and gather by the first
    # traversal's, cat (after every range) by the second traversal's graph
    _launch(55.0, corr=1), _launch(120.0, corr=2),
    _launch(130.0, "cudaLaunchKernelExC", corr=3),
    _launch(410.0, "cuLaunchKernel"), _launch(15.0),
    _launch(700.0, "cudaGraphLaunch", corr=4),
    _launch(940.0), _ev("cudaMemcpyAsync", "cuda_runtime", 35.0, 3.0),
]


def test_busy_idle_and_launches_go_to_the_innermost_range():
    got = stages.read(EVENTS)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["dispatches"] == 2
    # 55, 120, 130, 410, 700 lie inside a dispatch; 15 under pad, 940 outside
    assert got["dispatch_launches"] == 5
    st = got["stages"]
    assert set(st) == {"pad", "dispatch", "embed", "traversal", "bucket_scan", stages.NO_RANGE}
    trav, scan = st["traversal"], st["bucket_scan"]
    assert trav["wall_s"] == pytest.approx(600e-6)
    assert trav["busy_s"] == pytest.approx(70e-6)  # [150, 200] + [380, 400]
    assert trav["idle_s"] == pytest.approx(530e-6)
    assert trav["launches"] == 3
    assert trav["launched_s"] == pytest.approx(80e-6)  # where + gather + cat, whole
    assert scan["busy_s"] == pytest.approx(10e-6) and scan["launches"] == 1
    assert scan["launched_s"] == 0.0  # its call carries no correlation id
    assert st["embed"] == pytest.approx({"wall_s": 50e-6, "busy_s": 20e-6, "idle_s": 30e-6,
                                         "launches": 1, "launched_s": 20e-6})
    # dispatch's own pieces: [40, 50], [430, 440], [530, 600], [900, 930]
    assert st["dispatch"]["wall_s"] == pytest.approx(120e-6)
    assert st["dispatch"]["busy_s"] == pytest.approx(0.0)
    assert st["pad"]["busy_s"] == pytest.approx(5e-6) and st["pad"]["launches"] == 1
    assert st[stages.NO_RANGE]["busy_s"] == pytest.approx(20e-6)
    assert st[stages.NO_RANGE]["launches"] == 1
    # the pieces tile the window
    assert sum(r["wall_s"] for r in st.values()) == pytest.approx(1e-3)
    assert sum(r["busy_s"] for r in st.values()) == \
        pytest.approx(trace.read(EVENTS)["busy_s"])
    assert sum(r["launched_s"] for r in st.values()) == pytest.approx(100e-6)
    text = stages.table(got)
    assert "traversal" in text and "2.5 launches a batch" in text
    assert "launched ms" in text


# two batches of the beam as its kernel runs it: the level loop's range
# holds the wrapper and one launch, and the kernel runs after the range has
# closed, while the bucket scan's range is open or after it
AFTER = [
    _ev(trace.WINDOW, "user_annotation", 0.0, 1000.0),
    _rng("dispatch", 100.0, 300.0),
    _rng("traversal", 110.0, 20.0),
    _launch(120.0, corr=11),
    _ev("beam_kernel", "kernel", 150.0, 60.0, corr=11),
    _rng("bucket_scan", 140.0, 100.0),
    _launch(150.0, corr=12),
    _ev("bucket_kernel", "kernel", 215.0, 10.0, corr=12),
    _rng("dispatch", 500.0, 300.0),
    _rng("traversal", 510.0, 20.0),
    _ev("cudaFuncSetAttribute", "cuda_runtime", 512.0, 1.0, corr=20),
    _launch(520.0, corr=21),
    _ev("beam_kernel", "kernel", 560.0, 80.0, corr=21),
    _ev("Memset", "gpu_memset", 700.0, 4.0, corr=22),
    _ev("cudaMemsetAsync", "cuda_runtime", 600.0, 2.0, corr=22),  # outside traversal
]


def test_work_launched_in_a_range_counts_to_it_after_the_range_closes():
    st = stages.read(AFTER)["stages"]
    trav = st["traversal"]
    assert trav["busy_s"] == 0.0  # by overlap the range sees none of its kernel
    assert trav["launches"] == 2
    assert trav["launched_s"] == pytest.approx(140e-6)  # 60 + 80, by correlation id
    assert st["bucket_scan"]["launched_s"] == pytest.approx(10e-6)
    assert st["dispatch"]["launched_s"] == pytest.approx(4e-6)


def test_a_trace_without_the_programs_ranges_reads_none():
    plain = [e for e in EVENTS if not e["name"].startswith(stages.PREFIX)]
    assert stages.read(plain) is None
    assert stages.read([e for e in EVENTS if e["name"] != trace.WINDOW]) is None


def test_the_command_prints_the_table(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert stages.main([str(path)]) == 0
    assert "bucket_scan" in capsys.readouterr().out
    assert stages.main([str(tmp_path / "missing.json")]) == 1


def _run(**kw):
    cell = spec.Cell(spec.load_spec(), B512)
    base = dict(config=cell.config, traffic=cell.traffic, profile=None, telemetry=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture
def beam_spans():
    from repro_torch.core import telemetry as telem

    telem.reset()
    telem.enable()
    telem.observe("stage_seconds", 0.020, stage="traversal", engine="infinity", mode="beam")
    telem.observe("stage_seconds", 0.030, stage="traversal", engine="infinity", mode="beam")
    telem.observe("stage_seconds", 0.001, stage="bucket_scan", engine="infinity", mode="beam")
    # a traversal of another mode is not the beam's level loop
    telem.observe("stage_seconds", 9.0, stage="traversal", engine="infinity",
                  mode="best_first")
    telem.disable()
    yield
    telem.reset()


def test_span_readers(beam_spans):
    tel = {"spans": {}, "walls": [], "batches": 2}
    assert spec.reader("beam_levels_ms.b512")(_run(telemetry=tel)) == pytest.approx(25.0)
    assert spec.reader("bucket_scan_ms.b512")(_run(telemetry=tel)) == pytest.approx(1.0)
    assert spec.reader("beam_levels_ms.b512")(_run()) is None


def test_device_trace_readers_read_the_cells_trace(monkeypatch, tmp_path):
    out = tmp_path / "bench"
    (out / "out").mkdir(parents=True)
    (out / "out" / f"{B512}.trace.json").write_text(json.dumps({"traceEvents": EVENTS}))
    monkeypatch.setattr(spec, "BENCH", out)
    # the traffic files stay the repo's: only the output directory moves
    (out / "traffic").symlink_to(spec.ROOT / "bench" / "traffic")
    run = _run(profile={"batches": 2, "window_s": 1e-3, "busy_s": 1e-4})
    assert spec.reader("launches_per_batch.b512")(run) == pytest.approx(2.5)
    assert spec.reader("beam_device_ms.b512")(run) == pytest.approx(0.040)  # 80 µs / 2
    (out / "out" / f"{B512}.trace.json").write_text(json.dumps({"traceEvents": AFTER}))
    stages._read_file.cache_clear()  # the rewrite may keep the file's mtime
    assert spec.reader("beam_device_ms.b512")(run) == pytest.approx(0.070)  # 140 µs / 2
    # a run at another traffic is no cell: its trace is not looked for
    other = _run(profile=run.profile, traffic=dict(run.traffic, batch=64))
    assert stages.cell_name(other) is None
    assert spec.reader("launches_per_batch.b512")(other) is None


def test_readers_read_nothing_from_an_empty_run(tmp_path, monkeypatch):
    from repro_torch.core import telemetry as telem

    telem.reset()  # no span recorded
    monkeypatch.setattr(spec, "BENCH", tmp_path)  # no trace there
    (tmp_path / "traffic").symlink_to(spec.ROOT / "bench" / "traffic")
    for name in BEAM_METRICS:
        assert spec.reader(name)(_run()) is None, name
        assert spec.reader(name)(_run(profile={"batches": 1}, telemetry={"spans": {}})) \
            is None, name


@pytest.mark.gpu
def test_the_b512_cell_reports_the_beam_metrics_on_the_card(card, monkeypatch):
    """q2-b512's traffic over a smaller corpus, traced for a short window: a
    few dozen launches a batch (the level loop one of them), and one launch
    of the level-loop kernel a ``search_beam`` call."""
    from repro_torch.core import vptree
    from repro_torch.kernels import _build

    calls = []
    search_beam = vptree.search_beam

    def counted(*args, **kwargs):
        calls.append(1)
        return search_beam(*args, **kwargs)

    monkeypatch.setattr(vptree, "search_beam", counted)
    small = {"dataset": {"train": 8000, "test": 1024},
             "index": {"train_steps": 50, "proj_sample": 512}}
    cell = spec.Cell(spec.load_spec(), Q2_B512).override(small)
    _build.reset_launches()
    result, _ = main.execute(cell, seed=2**31 + 29, seconds=2.0, trace=True, device=card,
                               t_start=time.perf_counter(), log=lambda s: None)
    assert result["correct"], result["checks"]
    got = {m: result["metrics"].get(m, {}).get("value") for m in BEAM_METRICS}
    assert all(v is not None and np.isfinite(v) for v in got.values()), got
    assert 1 <= got["launches_per_batch.b512"] < 100
    assert got["beam_device_ms.b512"] > 0
    assert calls and _build.launches()["beam/levels"] == len(calls)
