"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits in
a file of its own under this folder, found by that name:

- ``configs/<config>.json``: the configuration (its ``file`` in the manifest);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  generator that reads it, ``drivers/<kind>.py``;
- ``workloads/<cell>.json``: the cell's own parameters (the sample that is
  checked, and the limits of the comparison that decides ``correct``);
- ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns the value or None where it finds nothing.

A later cell or metric is added as files and manifest entries; no file
here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, bench: dict, name: str, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _read_json(here.parent / self.config_entry["file"])
        self.traffic = _read_json(here / "traffic"
                                  / f"{self.entry['traffic']}.json")
        self.params = _read_json(here / "workloads" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and ("workloads" in m or m["moves"] in e2e_names)]
        self.here = here

    def driver(self):
        """The generator module of this cell's traffic kind."""
        kind = self.traffic["kind"]
        return importlib.import_module(f"slambench.drivers.{kind}")

    def reader(self, metric: str):
        """The ``read(ctx)`` function of a per-layer metric."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"slambench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load(path: Path = MANIFEST) -> dict:
    return _read_json(path)


def cell(name: str, path: Path = MANIFEST, here: Path = HERE) -> Cell:
    return Cell(load(path), name, here)
