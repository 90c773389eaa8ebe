"""The program's own spans and counters in a traced run, and the device's idle
time by the program span the host was in.

The port records its spans and counts (``cuddhelmholtz_tpu_torch/utils/spans.py``)
while a ``torch.profiler`` recording runs, so a ``--trace 1`` window leaves
them in the recorder's last recording, stamped on the clock of the device
trace.  Each idle gap of the trace goes to the innermost program span
around the gap's middle, the rule ``trace.py::DeviceTrace.idle_gaps``
applies to the benchmark's own spans; a gap with no program span around it
goes to ``OUTSIDE``.  Every gap goes somewhere, so the split adds up to the
run's ``device_idle_pct``.

A program without the recorder, an untraced run or a window that recorded
no span gives None to every reader here, and the metric is left out.
"""

from __future__ import annotations

from .stats import gaps

OUTSIDE = "outside"


def recording(run):
    """The program's recording of ``run``'s traced window, or None."""
    if run.trace is None:
        return None
    try:
        from cuddhelmholtz_tpu_torch.utils import spans
    except ImportError:
        return None
    rec = spans.last()
    return rec if rec is not None and rec.spans else None


def count(run, name: str):
    """The window's count of the program counter ``name`` (0 if it never
    counted), or None without a recording."""
    rec = recording(run)
    return None if rec is None else rec.counts.get(name, 0)


def durations_ms(run, name: str):
    """The durations of the window's program spans ``name``, in ms, or None
    where there are none."""
    rec = recording(run)
    if rec is None:
        return None
    out = [(e - s) / 1e6 for n, s, e, _, _ in rec.spans if n == name and e > 0]
    return out or None


def self_ns(spans) -> list:
    """Each span's duration less its child spans', in ns, for a list of
    (name, start_ns, end_ns, parent, root)."""
    own = [e - s for _, s, e, _, _ in spans]
    for _, s, e, parent, _ in spans:
        if parent is not None:
            own[parent] -= e - s
    return own


def innermost(spans, points) -> list:
    """For each of the sorted ``points``, the index of the innermost span
    (start <= point <= end) of the nested ``spans``, or None."""
    done = [i for i, (_, s, e, _, _) in enumerate(spans) if e > 0]
    done.sort(key=lambda i: (spans[i][1], -spans[i][2]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(done) and spans[done[j]][1] <= t:
            i = done[j]
            while stack and spans[stack[-1]][2] < spans[i][1]:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


_LAST: list = [None, None, None]  # (trace, recording, idle by span) of the last call


def idle_by_span(run) -> dict | None:
    """Idle device ns of ``run``'s traced window by the index of the
    innermost program span around each gap's middle (None: outside every
    span), or None without a recording."""
    rec = recording(run)
    if rec is None:
        return None
    if _LAST[0] is run.trace and _LAST[1] is rec:
        return _LAST[2]
    tr = run.trace
    idle = gaps(tr.clipped(), tr.start_ns, tr.end_ns)
    by: dict = {}
    for (s, e), i in zip(idle, innermost(rec.spans, [0.5 * (s + e) for s, e in idle])):
        by[i] = by.get(i, 0) + (e - s)
    _LAST[:] = [run.trace, rec, by]
    return by


def idle_split(run) -> dict | None:
    """Idle device seconds by the name of the innermost program span
    (``OUTSIDE`` for none), or None without a recording."""
    by = idle_by_span(run)
    if by is None:
        return None
    spans = recording(run).spans
    out: dict = {}
    for i, ns in by.items():
        name = OUTSIDE if i is None else spans[i][0]
        out[name] = out.get(name, 0.0) + ns / 1e9
    return out


def idle_pct(run, match) -> float | None:
    """100 x the idle device time whose innermost program span has a name
    that ``match`` accepts, over the traced window."""
    split = idle_split(run)
    if split is None or run.trace.window_s <= 0:
        return None
    idle = sum(v for n, v in split.items() if n != OUTSIDE and match(n))
    return 100.0 * idle / run.trace.window_s


def idle_under_s(run, name: str) -> float | None:
    """Idle device seconds whose innermost program span is ``name`` or lies
    under a span ``name``."""
    by = idle_by_span(run)
    if by is None:
        return None
    spans = recording(run).spans
    total = 0
    for i, ns in by.items():
        while i is not None and spans[i][0] != name:
            i = spans[i][3]
        if i is not None:
            total += ns
    return total / 1e9
