"""solve_ms_p90: the 90th percentile of every request's latency in the window,
from the request's start to its synchronised solution, in ms."""

from benchmark.stats import percentile


def read(run):
    return 1e3 * percentile([r["latency_s"] for r in run.requests], 90)
