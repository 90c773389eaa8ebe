"""ms_per_precond.composite: the window's request seconds over its
applications of P, in ms."""


def read(run):
    return 1e3 * sum(r["latency_s"] for r in run.requests) / sum(r["precond"] for r in run.requests)
