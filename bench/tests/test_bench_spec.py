"""``BENCHMARK.json`` keeps to the benchmark's contract, every cell and
metric loads by name from its own file, and a new cell, traffic mix or
metric is a new file and an entry, with no existing file edited."""
import json
import re
import shutil

import pytest

from bench.harness import spec

SPEC = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    cells = 24
    assert (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    groups = [SPEC["configs"], SPEC["workloads"], SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in SPEC["configs"]:
        assert _line(c["source"]) and c["reduced"] == [] and c["file"].startswith("bench/")
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_and_reports_enough(cell):
    c = spec.Cell(SPEC, cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, cell
    assert c.config["name"] == c.workload["config"]
    assert c.traffic["loop"] == "closed"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            reported = {e["name"] for e in spec.Cell(SPEC, cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_is_new_files_only(tmp_path):
    """A later cell brings its traffic file, a metric reader and entries in
    BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(spec.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    new = json.loads(json.dumps(SPEC))
    new["workloads"].append({"name": "fmnist784-infinity-b32", "config": "fmnist784-infinity",
                             "traffic": "closed-b32", "chips": 1,
                             "why": "batches of 32: the best-first path"})
    new["per_layer"].append({"name": "answers_per_batch.b32", "unit": "queries",
                             "better": "higher", "source": "host_clock", "layer": "server",
                             "moves": "qps", "workloads": ["fmnist784-infinity-b32"]})
    for m in new["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("fmnist784-infinity-b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    (tmp_path / "bench/traffic/closed-b32.json").write_text(
        '{"loop": "closed", "batch": 32, "k": 10}')
    (tmp_path / "bench/metrics/answers_per_batch.b32.py").write_text(
        "def read(run):\n    return run.window['attempted'] / run.window['batches']\n")
    cell = spec.Cell(spec.load_spec(tmp_path), "fmnist784-infinity-b32", root=tmp_path)
    assert cell.traffic["batch"] == 32
    assert [m["name"] for m in cell.per_layer] == ["answers_per_batch.b32"]
    assert "qps" in {m["name"] for m in cell.end_to_end}
    read = spec.reader("answers_per_batch.b32", root=tmp_path)
    assert read(type("R", (), {"window": {"attempted": 640, "batches": 20}})) == 32
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data, rel
