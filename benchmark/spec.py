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
    benchmark/grids/<grid>.py         (``grid(config)``: the canonical discretisation)
    benchmark/reference/<reference>.py
                                      (``build(config, grid, a_nodal, device, dtype)``:
                                       the plain DDH reference, with ``ReferenceDDH.solve``)

so a new cell, configuration, discretisation, reference, speed model, check
number or metric is new files and entries only.  A configuration without
``"grid"`` is on the ``"structured"`` grid, and one without ``"reference"``
is checked against ``"ddh"``.

A grid is all the harness knows of the canonical discretisation, the node
numbering that every benchmark input and reference quantity is written in:

    ndof                the number of nodes
    coords()            (ndof, 2) float64 node coordinates
    lumped_mass()       (ndof,) the GLL-collocated (lumped) mass diagonal
    match(coords)       the canonical id of each of the (n, 2) points, which
                        raises where a point is not a node within 1e-9 or
                        two points are one node
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run: the JAX package and
# JAX itself (compared whole, since the port's name begins with the JAX
# package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cuddhelmholtz_tpu"})

# the code a configuration names by these keys, where it names none
DEFAULT = {"grid": "structured", "reference": "ddh"}


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_MODULES: dict = {}


def load_module(base: Path, folder: str, name: str):
    """The module ``<base>/<folder>/<name>.py``, loaded once.  A module of a
    package folder (``reference/``) is loaded under the package's name, so
    that its relative imports resolve."""
    path = base / folder / f"{name}.py"
    if path not in _MODULES:
        if (base / folder / "__init__.py").is_file():
            key = f"{__package__}.{folder}.{name}"
        else:
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
    _grid: object = field(default=None, init=False, repr=False, compare=False)

    def grid(self):
        """The canonical discretisation, ``grids/<grid>.py::grid(config)``,
        built once."""
        if self._grid is None:
            self._grid = load_module(self.base, "grids",
                                     self.config.get("grid", DEFAULT["grid"])).grid(self.config)
        return self._grid

    def reference(self, grid, a_nodal, device, dtype):
        """The plain DDH reference of the nodal model ``a_nodal`` (canonical
        numbering), ``reference/<reference>.py::build``."""
        name = self.config.get("reference", DEFAULT["reference"])
        build = load_module(self.base, "reference", name).build
        return build(self.config, grid, a_nodal, device, dtype)

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
    config = load_json(base / "configs" / f"{w['config']}.json")
    for key, folder in (("grid", "grids"), ("reference", "reference")):
        code = config.get(key, DEFAULT[key])
        if not (base / folder / f"{code}.py").is_file():
            raise ValueError(f"configuration {w['config']!r} names the {key} {code!r}: "
                             f"there is no {folder}/{code}.py")
    return Cell(
        name=name,
        config=config,
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        check={k: float(v) for k, v in own["check"].items()},
        sample=own["sample"],
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        base=base,
    )
