"""A benchmark cell, found by name: its entry of `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the driver the mix names
(`drivers/<driver>.py`), its limits (`limits/<cell>.json`) and the readers
of its per-layer metrics (`metrics/<metric>.py`). A new cell, mix or metric
is a new file and a new entry; no file here changes."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Cell", "load", "per_layer_metrics", "end_to_end_metrics", "read_metric"]

HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the workload's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict       # check name -> limit
    benchmark: dict    # the whole BENCHMARK.json
    root: Path = HERE.parent

    def driver(self):
        return importlib.import_module(f"h100_bench.drivers.{self.traffic['driver']}")


def load(name: str, root: Path = HERE.parent) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`; raises KeyError for a
    name that is not there."""
    bench = _json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / "h100_bench" / "traffic" / f"{entry['traffic']}.json")
    limits = _json(root / "h100_bench" / "limits" / f"{name}.json")
    return Cell(name, entry, config, traffic, limits, bench, root)


def per_layer_metrics(cell: Cell) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in cell.benchmark["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])}
    return [m for m in cell.benchmark["per_layer"]
            if cell.name in m.get("workloads", []) or
            ("workloads" not in m and m["moves"] in e2e)]


def end_to_end_metrics(cell: Cell) -> list:
    return [m for m in cell.benchmark["end_to_end"]
            if cell.name in m.get("workloads", [cell.name])]


def read_metric(name: str, window, root: Path = HERE.parent):
    """Run the reader `metrics/<name>.py` on a traced window: its `read`
    returns a number, or None where it finds nothing to read."""
    path = root / "h100_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(window)
