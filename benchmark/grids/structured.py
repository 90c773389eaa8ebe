"""The uniform structured grid of ``reference/grid.py``: ``nx`` x ``nx``
square quads on [-1, 1]^2 at degree ``deg``.  A configuration that names no
``"grid"`` is on this one."""

from benchmark.reference.grid import Grid


def grid(config: dict) -> Grid:
    return Grid(config["nx"], config["deg"])
