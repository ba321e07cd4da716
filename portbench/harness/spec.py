"""The benchmark's description and its pieces, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration,
traffic mix and metrics. Every piece is a file of its own under
``portbench/``, found by that name, so a later change adds a configuration,
a mix, a metric or a cell's limits by adding files:

- ``configs/<config>.json``: the sizes as run; its ``family`` names the
  program-side module ``families/<family>.py`` and the plain reference
  ``reference/<family>.py``;
- ``traffic/<mix>.json``: the mix's parameters; its ``driver`` names the
  general loop ``drivers/<driver>.py`` that reads them;
- ``metrics/<metric>.py``: the reader of one per-layer metric, or, where
  no such file is there, ``metrics/<stem>.py`` for the part of the name
  before its first dot: one reader serves ``device_idle.fit`` and any later
  ``device_idle.<cell kind>``;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass, field
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    chips: int = 1
    root: pathlib.Path = HERE


def _read(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, end_to_end_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def load_cell(name: str, root: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``<root>/../BENCHMARK.json`` with its pieces, all
    read from files under ``root``."""
    bench = _read(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    config = _read(root / "configs" / f"{w['config']}.json")
    config["name"] = w["config"]
    traffic = _read(root / "traffic" / f"{w['traffic']}.json")
    traffic["name"] = w["traffic"]
    limits_path = root / "limits" / f"{name}.json"
    limits = _read(limits_path) if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, config, traffic, limits, e2e, per_layer, w.get("chips", 1), root)


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module: a driver or a family."""
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"{kind} name {name!r} is not a module name")
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_reader(name: str, root: pathlib.Path = HERE):
    """The ``read`` function of ``<root>/metrics/<name>.py``, else of
    ``<root>/metrics/<stem>.py`` (a metric's name may hold dots, so the file
    is loaded by its path)."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    safe = re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    return _from_file(path, f"portbench_metric_{safe}").read


def _from_file(path: pathlib.Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
