"""host_syncs_per_matvec.lambda: the window's blocking host reads of the
Krylov loops (the program counter ``gmres.host_syncs``) over its
lambda-GMRES matvec applications (a block solve's apply of its batch counts
once, as in ``ms_per_matvec.lambda``)."""

from benchmark.program_spans import count


def read(run):
    syncs = count(run, "gmres.host_syncs")
    if not syncs:
        return None
    matvecs = sum(r["matvecs"] for r in run.requests)
    return syncs / matvecs if matvecs else None
