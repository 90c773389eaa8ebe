"""Find a cell's configuration, traffic mix, check and code by name.

``BENCHMARK.json`` lists cells and metrics as data.  Everything that belongs
to one configuration, one traffic mix, one cell or one per-layer metric is a
file of its own, found by its name:

    benchmark/configs/<config>.json
    benchmark/traffic/<traffic>.json
    benchmark/cells/<cell>.json       (the check's limits and sample)
    benchmark/metrics/<metric>.py     (``read(run) -> float | None``)

and the code that a configuration or a check names is found the same way:

    benchmark/systems/<kind>.py       (``System``: the system under test)
    benchmark/speeds/<speed>.py       (``speed(xy)``: the wave-speed model)
    benchmark/numbers/<number>.py     (``reading(cell, grid, items, device)``)

so a new cell, configuration, speed model, check number or metric is new
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run: the JAX package and
# JAX itself (compared whole, since the port's name begins with the JAX
# package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cuddhelmholtz_tpu"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(base: Path, folder: str, name: str):
    """The module ``<base>/<folder>/<name>.py``, loaded once."""
    path = base / folder / f"{name}.py"
    if path not in _MODULES:
        key = f"benchmark_{folder}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def metric_reader(name: str, base: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    return load_module(base, "metrics", name).read


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    check: dict  # {number: limit}
    sample: int | str  # how many of the window's requests are compared, or "all"
    chips: int
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    base: Path = HERE

    def system(self):
        """The class of the system under test, ``systems/<kind>.py``."""
        return load_module(self.base, "systems", self.config["kind"]).System

    def speed(self, xy):
        """The configuration's wave-speed model at points ``xy``."""
        return load_module(self.base, "speeds", self.config["speed"]).speed(xy)

    def number(self, name: str):
        """``reading`` of the check number ``numbers/<name>.py``."""
        return load_module(self.base, "numbers", name).reading

    def reader(self, name: str):
        return metric_reader(name, self.base)


def load_cell(name: str, bench: dict | None = None, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default), with
    its files read from ``base``."""
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    own = load_json(base / "cells" / f"{name}.json")
    return Cell(
        name=name,
        config=load_json(base / "configs" / f"{w['config']}.json"),
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        check={k: float(v) for k, v in own["check"].items()},
        sample=own["sample"],
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        base=base,
    )
