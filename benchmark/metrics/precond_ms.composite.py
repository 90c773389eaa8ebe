"""precond_ms.composite: the mean host duration of the program span
``ddh.precond`` (one application of P), in ms: the inside counterpart of
``ms_per_precond.composite``."""

from benchmark.program_spans import durations_ms


def read(run):
    ms = durations_ms(run, "ddh.precond")
    return sum(ms) / len(ms) if ms else None
