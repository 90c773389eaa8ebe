"""step_ms.lambda: the mean host duration of the program span ``gmres.step``
(one Arnoldi step with its matvec; one block step in block GMRES), in ms:
the inside counterpart of ``ms_per_matvec.lambda``."""

from benchmark.program_spans import durations_ms


def read(run):
    ms = durations_ms(run, "gmres.step")
    return sum(ms) / len(ms) if ms else None
