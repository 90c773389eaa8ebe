"""ms_per_matvec.lambda: the window's request seconds over its lambda-GMRES
matvec applications, in ms (a block solve's apply of its batch counts once)."""


def read(run):
    return 1e3 * sum(r["latency_s"] for r in run.requests) / sum(r["matvecs"] for r in run.requests)
