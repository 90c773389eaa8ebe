"""matvecs_per_request.lambda: the lambda-GMRES result's ``num_matvec`` per
request (a block solve's apply of its batch counts once)."""


def read(run):
    return sum(r["matvecs"] for r in run.requests) / len(run.requests)
