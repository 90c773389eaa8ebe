"""The upstream examples' wave-speed model a = 1/c: 0.2 inside the r = 0.25
disc, 1 outside (``reference.grid.disc_speed``)."""

from benchmark.reference.grid import disc_speed as speed  # noqa: F401
