"""prepare_idle_ms.setup: the idle device time whose innermost program span
is ``ddh.prepare`` or one of its children (``ddh.groups``, ``ddh.probe``,
``ddh.route``, ``ddh.io_maps``), per new model, in ms."""

from benchmark.program_spans import idle_under_s


def read(run):
    idle = idle_under_s(run, "ddh.prepare")
    return 1e3 * idle / len(run.requests) if idle and run.requests else None
