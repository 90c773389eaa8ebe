"""Reduce a ``torch.profiler`` trace of the window to what the metrics read.

The profiler records the device's kernels, copies and sets (CUPTI); the
benchmark records its own spans on the host clock.  Kineto stamps both kinds
of event in nanoseconds of the Unix epoch, so the spans are kept on that
clock (``time.time_ns``) and line up with the device intervals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .stats import gaps, union_length


@dataclass
class DeviceTrace:
    """Device operations of a traced window: (name, start_ns, end_ns)."""

    ops: list = field(default_factory=list)
    start_ns: int = 0
    end_ns: int = 0

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def clipped(self):
        return [(max(s, self.start_ns), min(e, self.end_ns)) for _, s, e in self.ops
                if e > self.start_ns and s < self.end_ns]

    @property
    def busy_s(self) -> float:
        return union_length(self.clipped()) / 1e9

    def seconds_in(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.ops:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], ns / 1e9] for n, ns in top]

    def idle_gaps(self, spans, k: int = 10) -> list:
        """Idle device time by what the host was doing: each gap between
        device operations goes to the innermost benchmark span (name,
        start_ns, end_ns) around its middle, else to "between requests"."""
        by: dict = {}
        for s, e in gaps(self.clipped(), self.start_ns, self.end_ns):
            mid = 0.5 * (s + e)
            inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
            name = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "between requests"
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]


def device_ops(prof) -> list:
    """(name, start_ns, end_ns) of every device operation in a finished
    ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
    return ops
