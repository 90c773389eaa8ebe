"""The idle device time whose innermost program span is one of the Krylov
loops' (``gmres.solve``, ``gmres.step``, ``gmres.sync``), in % of the traced
window."""

from benchmark.program_spans import idle_pct


def read(run):
    return idle_pct(run, lambda name: name.startswith("gmres."))
