"""precond_per_rhs.composite: applications of the DDH preconditioner P (the
hook's ``precond.calls``) per right-hand side."""


def read(run):
    return sum(r["precond"] for r in run.requests) / sum(r["n_rhs"] for r in run.requests)
