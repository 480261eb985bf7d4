"""Finding the pieces of a cell by name.

``BENCHMARK.json`` at the root names the cells, the configurations and the
metrics.  Everything that belongs to one of them sits in a file of its own,
found by its name, so that a new cell, configuration, traffic mix or
metric is a new file and an entry, and no existing file changes:

* a configuration: the JSON file its entry names (``bench/configs/``);
* a traffic mix: ``bench/traffic/<traffic>.json``, read by the one general
  generator in ``harness/traffic.py``;
* a metric: ``bench/metrics/<name>.py``, a reader with ``read(run)`` that
  returns the value, or None when the run holds nothing for it to read.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over`` laid on top, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for key, val in (over or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and the metrics it reports."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        entry = configs[self.workload["config"]]
        with open(root / entry["file"]) as fh:
            self.config = json.load(fh)
        with open(root / "bench" / "traffic" / f"{self.workload['traffic']}.json") as fh:
            self.traffic = json.load(fh)
        self.end_to_end = [m for m in spec["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if self._reports(m) and m["moves"] in reported]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def override(self, config: dict | None = None, traffic: dict | None = None) -> "Cell":
        """A copy with parts of the configuration and the traffic replaced
        (the tests run cells at a size the CPU holds)."""
        other = copy.copy(self)
        other.config = merge(self.config, config)
        other.traffic = merge(self.traffic, traffic)
        return other


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of metric ``name`` (``bench/metrics/<name>.py``;
    the name may hold dots, so the file is loaded by path)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
