"""The share of the traced window in which the device ran no operation: 100 x
(1 - the union of the device intervals / the window), in %."""

from benchmark.stats import device_idle_pct as read  # noqa: F401
