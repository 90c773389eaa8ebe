"""host_syncs_per_precond.composite: the window's blocking host reads of the
Krylov loops (the program counter ``gmres.host_syncs``: P's inner GMRES and
the outer FGMRES) over its applications of P."""

from benchmark.program_spans import count


def read(run):
    syncs = count(run, "gmres.host_syncs")
    if not syncs:
        return None
    applied = sum(r["precond"] for r in run.requests)
    return syncs / applied if applied else None
