"""The benchmark's metric arithmetic: percentiles, rates and the union of
device intervals.  Pure Python, so the CPU tests check it on synthetic logs."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, linear between the two
    nearest ranks (numpy's default and ``statistics.quantiles``'s
    "inclusive" method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted once."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        s = max(s, end)
        if e > s:
            total += e - s
        end = max(end, e)
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in merged(intervals):
        if e <= start or s >= end:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    """The share of the window in which the device ran nothing, in %."""
    return 100.0 * (1.0 - busy_s / window_s)


def device_idle_pct(run) -> float | None:
    """``idle_pct`` of a run's traced window; None for an untraced run."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return idle_pct(run.trace.busy_s, run.trace.window_s)
