"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its
traffic mix; the configuration's entry names its file, the traffic mix is
``traffic/<traffic>.json``, the cell's limits ``limits/<cell>.json``, and
each per-layer metric's reader ``metrics/<metric>.py``.  Nothing here
lists a cell, a configuration, a mix or a metric: adding one is adding
its files and its entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    traffic: dict             # the traffic mix's file
    limits: dict              # the correctness numbers' limits
    end_to_end: list          # the cell's end-to-end metric entries
    per_layer: list           # the cell's per-layer metric entries
    root: Path

    @property
    def model(self) -> dict:
        """The configuration as the program runs it."""
        return self.config["model"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "bench"
    limits_path = here / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=w["chips"],
        config=_read(root / configs[w["config"]]["file"]),
        traffic=_read(here / "traffic" / f"{w['traffic']}.json"),
        limits=_read(limits_path) if limits_path.exists() else {},
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name), root=root)


def reader(cell: Cell, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = cell.root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
