"""rhs_per_s: right-hand sides solved to their tolerance over the window's
seconds (a batch request counts its right-hand sides)."""


def read(run):
    return sum(r["n_rhs"] for r in run.requests if r["ok"]) / run.window_s
